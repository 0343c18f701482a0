"""The port's serving entry points on the CPU, and their refusal to fall
back to the CPU when CUDA is asked for (explicitly or by default) and absent."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.serve_step import generate, sample_token  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = ["--smoke", "--batch", "2", "--prompt-len", "40", "--steps", "5"]


def test_serve_main_on_cpu_returns_token_ids(capsys):
    toks = serve.main(SMOKE + ["--device", "cpu"])
    assert toks.shape == (2, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < get_config(
        "gemma3-4b", smoke=True).vocab_size
    assert "[serve] prefill 2x40 on cpu" in capsys.readouterr().out
    # seeded: the same command gives the same tokens
    assert torch.equal(toks, serve.main(SMOKE + ["--device", "cpu"]))


def test_serve_main_mamba2_on_cpu(capsys):
    toks = serve.main(["--arch", "mamba2-780m"] + SMOKE + ["--device", "cpu"])
    assert toks.shape == (2, 5)
    assert int(toks.max()) < get_config("mamba2-780m", smoke=True).vocab_size
    assert "[serve] prefill 2x40 on cpu" in capsys.readouterr().out


def test_serve_main_recurrentgemma_on_cpu(capsys):
    toks = serve.main(["--arch", "recurrentgemma-9b"] + SMOKE + ["--device", "cpu"])
    assert toks.shape == (2, 5)
    assert int(toks.max()) < get_config("recurrentgemma-9b", smoke=True).vocab_size
    assert "[serve] prefill 2x40 on cpu" in capsys.readouterr().out


def test_serve_main_temperature_sampling_is_seeded():
    a = serve.main(SMOKE + ["--device", "cpu", "--temperature", "1.0"])
    b = serve.main(SMOKE + ["--device", "cpu", "--temperature", "1.0"])
    assert torch.equal(a, b)


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, -1.0]])
    assert sample_token(logits).tolist() == [[1], [0]]
    with pytest.raises(ValueError, match="Generator"):
        sample_token(logits, temperature=1.0)
    draws = sample_token(logits.repeat(512, 1), 0.5,
                         torch.Generator().manual_seed(0))
    assert draws.shape == (1024, 1)
    assert set(draws.flatten().tolist()) <= {0, 1, 2}


def test_generate_greedy_matches_prefill_argmax():
    cfg = get_config("gemma3-4b", smoke=True)
    m = Model(cfg, device="cpu", seed=3)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    toks = generate(m, prompt, 4)
    with torch.inference_mode():
        first, _ = m.prefill(prompt, 44)
    assert toks.shape == (2, 4)
    assert torch.equal(toks[:, 0], first.argmax(-1))


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma3-4b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"embed": {"table": np.zeros((2, 2), np.float32)}}, cfg)


def _run_smoke(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_fast_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def test_chip_smoke_kernels_only_fails_fast_without_gpu():
    r = _run_smoke(ROOT, "--kernels-only")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"kernels"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
