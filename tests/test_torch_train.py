"""The port's training substrate on the CPU: the tests/test_train.py
contracts (AdamW against numpy, the clip, the LR schedule, microbatch
equivalence, loss decrease, data determinism, resume and shifted labels),
the port's own data law, checkpoints, launch/train.py and the fault module.

Tolerances, with their reasons:
  * AdamW against numpy: 1e-5 relative, as tests/test_train.py;
  * microbatches 1 against 2: f32 grads 1e-5 x max |grad| per leaf (summation
    order); bf16 params after one step 3e-2, as tests/test_train.py;
  * a resumed launch/train.py run against an uninterrupted one: bit-equal (same CPU, same
    order of operations).
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Ctx, Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import (JUMP_PROBS, JUMPS, DataConfig,  # noqa: E402
                                    DataIterator, make_batch)
from repro_torch.train.optimizer import (OptConfig, adamw_update,  # noqa: E402
                                         global_norm, init_opt_state, lr_at)
from repro_torch.train.train_step import (TrainState, init_train_state,  # noqa: E402
                                          make_eval_step, make_train_step)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes
    at once, and torch's CPU thread pools in each would contend for the
    same cores (restored after, for the other files a worker runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke_model(dtype=torch.bfloat16, seed=0):
    m = Model(get_config("gemma3-4b", smoke=True), device="cpu", seed=seed,
              trainable=True)
    return m.to(dtype)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_matches_numpy_reference():
    cfg = OptConfig(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                    grad_clip=1e9, warmup_steps=0, total_steps=10**9,
                    min_lr_ratio=1.0)
    rng = np.random.RandomState(0)
    w, gn = rng.randn(4, 3).astype(np.float32), (rng.randn(4, 3) * 0.1).astype(np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    g = {"w": torch.from_numpy(gn)}
    newp, st, met = adamw_update(cfg, p, g, init_opt_state(p))
    mu, nu = 0.1 * gn, 0.05 * gn ** 2
    ref = w - 1e-2 * (mu / (1 - 0.9)) / (np.sqrt(nu / (1 - 0.95)) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)
    assert st.step == 1 and newp["w"] is p["w"]            # updated in place
    np.testing.assert_allclose(st.mu["w"].numpy(), mu, rtol=1e-6)


def test_adamw_decays_matrices_only_and_keeps_dtype():
    cfg = OptConfig(lr=0.5, weight_decay=0.1, warmup_steps=0, total_steps=10**9,
                    min_lr_ratio=1.0)
    p = {"m": torch.ones(2, 2, dtype=torch.bfloat16), "v": torch.ones(2, dtype=torch.bfloat16)}
    g = {"m": torch.zeros(2, 2, dtype=torch.bfloat16), "v": torch.zeros(2, dtype=torch.bfloat16)}
    adamw_update(cfg, p, g, init_opt_state(p))
    assert p["m"].dtype == torch.bfloat16 and p["v"].dtype == torch.bfloat16
    assert torch.all(p["m"] == 1 - 0.5 * 0.1) and torch.all(p["v"] == 1)
    # a vector that the JAX layout stacks into a matrix decays too
    adamw_update(cfg, p, g, init_opt_state(p), ndims={"m": 2, "v": 2})
    assert torch.all(p["v"] == 1 - 0.5 * 0.1)


def test_stacked_ndims_follow_the_jax_layout():
    """gemma3-4b smoke: superblock (local, local, global) x 1 + one local
    remainder; its layers 0-2 are stacked in the JAX package, layer 3 not."""
    nd = _smoke_model().stacked_ndims()
    assert nd["layers.0.ln1.scale"] == nd["layers.2.attn.qnorm.scale"] == 2
    assert nd["layers.3.ln1.scale"] == 1 and nd["final_norm.scale"] == 1
    assert nd["layers.0.attn.wq"] == 4 and nd["layers.3.attn.wq"] == 3
    assert nd["embed.table"] == 2


def test_adamw_slices_a_large_leaf_as_the_whole(monkeypatch):
    """The update is elementwise, so slices give the bits of the whole leaf
    (no clip here: the global norm's sum runs in another order)."""
    from repro_torch.train import optimizer
    cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10, grad_clip=1e9)
    rng = np.random.RandomState(1)
    w, gr = rng.randn(64, 40).astype(np.float32), rng.randn(64, 40).astype(np.float32)
    whole = {"w": torch.from_numpy(w.copy())}
    adamw_update(cfg, whole, {"w": torch.from_numpy(gr)}, init_opt_state(whole))
    monkeypatch.setattr(optimizer, "SLICE", 100)
    sliced = {"w": torch.from_numpy(w.copy())}
    adamw_update(cfg, sliced, {"w": torch.from_numpy(gr)}, init_opt_state(sliced))
    assert torch.equal(whole["w"], sliced["w"])


def test_grad_clip_caps_update():
    cfg = OptConfig(lr=1.0, grad_clip=1e-3, warmup_steps=0, total_steps=10**9,
                    min_lr_ratio=1.0, weight_decay=0.0)
    p = {"w": torch.ones(8, 8)}
    g = {"w": torch.full((8, 8), 100.0)}
    _, st, met = adamw_update(cfg, p, g, init_opt_state(p))
    assert float(met["gnorm"]) > 100
    # the first moment saw the clipped gradient: 100 * 1e-3 / gnorm each
    clipped = 100.0 * 1e-3 / float(met["gnorm"])
    np.testing.assert_allclose(st.mu["w"].numpy(), 0.1 * clipped, rtol=1e-5)
    assert abs(float(global_norm(g)) - 800.0) < 1e-3


def test_lr_schedule_warmup_and_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert lr_at(cfg, 5) == 0.5
    assert abs(lr_at(cfg, 10) - 1.0) < 1e-6
    assert abs(lr_at(cfg, 110) - 0.1) < 1e-3


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def test_model_is_frozen_unless_trainable():
    cfg = get_config("gemma3-4b", smoke=True)
    assert not any(p.requires_grad for p in Model(cfg, device="cpu").parameters())
    assert all(p.requires_grad for p in Model(cfg, device="cpu", trainable=True).parameters())
    with pytest.raises(ValueError, match="trainable"):
        init_train_state(Model(cfg, device="cpu"))


def test_microbatch_grad_equivalence(monkeypatch):
    """microbatches=2 ~= microbatches=1 on the same batch: the f32 grads the
    optimizer sees, and the params after one step."""
    from repro_torch.train import train_step as ts
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    b = make_batch(DataConfig(vocab_size=512, seq_len=32, global_batch=8), 0, "cpu")
    seen = []

    def spy(cfg, params, grads, state, ndims):
        seen.append({k: g.float().clone() for k, g in grads.items()})
        return adamw_update(cfg, params, grads, state, ndims)

    monkeypatch.setattr(ts, "adamw_update", spy)
    models, mets = {}, {}
    for m in (1, 2):
        model = _smoke_model(torch.float32)
        step = make_train_step(model, opt, ParallelConfig(microbatches=m, remat="none"))
        _, mets[m] = step(init_train_state(model), b)
        models[m] = model
    seen = dict(zip((1, 2), seen))
    for k, g1 in seen[1].items():
        err = (g1 - seen[2][k]).abs().max().item()
        assert err <= 1e-5 * max(g1.abs().max().item(), 1e-30), (k, err)
    assert abs(float(mets[1]["loss"]) - float(mets[2]["loss"])) < 1e-5
    for (k, a), (_, bb) in zip(models[1].named_parameters(), models[2].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), bb.detach().numpy(), atol=3e-2,
                                   err_msg=k)


def test_loss_decreases_on_gemma_smoke():
    """End-to-end training contract: a small model learns the synthetic data."""
    model = _smoke_model()
    par = ParallelConfig(remat="none")
    step = make_train_step(model, OptConfig(lr=1e-2, warmup_steps=5, total_steps=60), par)
    state = init_train_state(model)
    it = DataIterator(DataConfig(vocab_size=512, seq_len=64, global_batch=8), device="cpu")
    losses = []
    for _ in range(40):
        state, metrics = step(state, next(it))
        losses.append(float(metrics["loss"]))
        assert set(metrics) >= {"loss", "ce", "zloss", "aux", "ntok", "gnorm", "lr"}
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    ev = make_eval_step(model, par)(next(it))
    assert np.isfinite(float(ev["loss"])) and float(ev["ntok"]) == 8 * 64


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_determinism_and_resume():
    dc = DataConfig(vocab_size=1000, seq_len=32, global_batch=4)
    assert torch.equal(make_batch(dc, 7, "cpu")["tokens"], make_batch(dc, 7, "cpu")["tokens"])
    assert not torch.equal(make_batch(dc, 7, "cpu")["tokens"], make_batch(dc, 8, "cpu")["tokens"])
    other = DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=1)
    assert not torch.equal(make_batch(dc, 7, "cpu")["tokens"], make_batch(other, 7, "cpu")["tokens"])
    it1 = DataIterator(dc, start_step=0, device="cpu")
    for _ in range(5):
        next(it1)
    b_at_5 = next(it1)
    b_resumed = next(DataIterator(dc, start_step=5, device="cpu"))
    assert torch.equal(b_at_5["tokens"], b_resumed["tokens"])
    assert torch.equal(b_at_5["labels"], b_resumed["labels"])


def test_labels_are_shifted_tokens():
    b = make_batch(DataConfig(vocab_size=1000, seq_len=32, global_batch=2), 3, "cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 32)
    assert b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_follows_the_jump_law():
    """Outside the spliced motif, consecutive tokens differ by 1, 2, 3 or 5
    (mod vocab) with probabilities 0.55, 0.2, 0.15, 0.1."""
    seq, vocab = 256, 97
    b = make_batch(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=64), 0, "cpu")
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    mid, motif = seq // 2, min(32, seq // 4)
    keep = [i for i in range(seq) if not mid - 1 <= i < mid + motif]
    d = ((toks[:, 1:] - toks[:, :-1]) % vocab)[:, keep]
    assert set(d.unique().tolist()) <= set(JUMPS)
    freq = np.array([(d == j).float().mean().item() for j in JUMPS])
    np.testing.assert_allclose(freq, JUMP_PROBS, atol=0.02)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < vocab


@pytest.mark.parametrize("seq", [16, 64, 200])
def test_data_splices_the_motif(seq):
    b = make_batch(DataConfig(vocab_size=1000, seq_len=seq, global_batch=3), 1, "cpu")
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    mid, n = seq // 2, min(32, seq // 4)
    assert torch.equal(toks[:, mid:mid + n], toks[:, :n])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_keep_and_latest(tmp_path):
    model = _smoke_model()
    state = init_train_state(model)
    with torch.no_grad():
        for v in state.opt.mu.values():
            v.normal_()
    state = TrainState(state.params, state.opt._replace(step=7), {})
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in ckpt.flatten_state(state).items()}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, state, meta={"arch": "x"}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    fresh = init_train_state(_smoke_model(seed=1))
    restored, meta = ckpt.restore_checkpoint(str(tmp_path), 4, fresh)
    assert meta["step"] == 4 and meta["arch"] == "x" and restored.opt.step == 7
    for k, v in ckpt.flatten_state(restored).items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k


def test_async_checkpoint_writes_the_state_at_call_time(tmp_path):
    state = init_train_state(_smoke_model())
    t = ckpt.save_checkpoint(str(tmp_path), 1, state, async_save=True)
    with torch.no_grad():
        state.params["embed.table"].zero_()
    t.join()
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), 1, init_train_state(_smoke_model()))
    assert torch.equal(restored.params["embed.table"],
                       _smoke_model().embed["table"].detach())


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

ARGS = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--steps", "6",
        "--seq-len", "32", "--batch", "4", "--log-every", "1"]


def _arrays(path):
    with np.load(path / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_launch_train_runs_and_writes_metrics(tmp_path):
    log = launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in log)
    assert json.loads((tmp_path / "metrics.json").read_text()) == log
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_launch_train_resume_matches_uninterrupted_run(tmp_path):
    full, cut = tmp_path / "full", tmp_path / "cut"
    want = launch_train.main(ARGS + ["--ckpt-dir", str(full), "--ckpt-every", "3"])
    launch_train.main(ARGS + ["--ckpt-dir", str(cut), "--ckpt-every", "3"])
    import shutil
    shutil.rmtree(cut / "step_00000006")            # as if stopped after step 3
    got = launch_train.main(ARGS + ["--ckpt-dir", str(cut), "--ckpt-every", "3",
                                    "--resume"])
    assert [m["step"] for m in got] == [3, 4, 5]
    assert [m["loss"] for m in got] == [m["loss"] for m in want[3:]]
    a, b = _arrays(full / "step_00000006"), _arrays(cut / "step_00000006")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_launch_train_retries_injected_fault(tmp_path, capsys):
    log = launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--inject-fault-at", "2"])
    assert [m["step"] for m in log] == list(range(6))
    assert "step 2 failed (injected fault at step 2); retry 1" in capsys.readouterr().out


def test_launch_train_refuses_grad_compression(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--grad-compression"])


@pytest.mark.parametrize("kw", [{"grad_compression": True}, {"pipeline_stages": 2},
                                {"attn_impl": "pallas"}])
def test_parallel_config_refuses_what_needs_a_mesh(kw):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        ParallelConfig(**kw)


# ---------------------------------------------------------------------------
# the copies and the CUDA-only refusals
# ---------------------------------------------------------------------------

def test_fault_module_is_a_copy_of_the_reference():
    """train/fault.py is the reference's file with two lines of docstring
    added."""
    ref = (ROOT / "src" / "repro" / "train" / "fault.py").read_text().splitlines()
    port = (ROOT / "src" / "repro_torch" / "train" / "fault.py").read_text().splitlines()
    assert port[:2] + port[5:] == ref, "the copy drifted from the reference"
    assert "repro/train/fault.py" in port[2] and port[4] == ""


def _operator_dispatch(module, op, wrapper, plain):
    """The operator repro_torch::<op> runs ``wrapper`` (the kernel) on a
    CUDA tensor and ``plain`` on a CPU tensor: its registered kernels, and
    the calls in kernels/<module>.py's registrations."""
    for key in ("CUDA", "CPU"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(f"repro_torch::{op}", key)
    src = (ROOT / "src" / "repro_torch" / "kernels" / f"{module}.py").read_text()
    cuda = src[src.index(f'"repro_torch::{op}"'):]
    cuda = cuda[:cuda.index("\n\n\n")]
    assert f"return {wrapper}(" in cuda
    cpu = src[src.index(f"@{op}_op.register_kernel(\"cpu\")"):]
    assert f"ref.{plain}(" in cpu[:cpu.index("\n\n\n")]


def test_rglru_runs_its_backward_kernel_on_the_card():
    """ops.rglru_scan under autograd goes through ops.RGLRU, whose backward
    is K3's backward kernel on a CUDA tensor: no refusal is left, and RGLRU
    calls the operators rglru_scan_fwd/rglru_scan_bwd, which dispatch on the
    device to the kernels or their plain versions."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "ops.py").read_text()
    assert "_no_backward" not in src and "RGLRU.apply(a, b)" in src
    body = src[src.index("class RGLRU("):src.index("def rglru_scan(")]
    assert "_ops.rglru_scan_fwd(" in body and "_ops.rglru_scan_bwd(" in body
    _operator_dispatch("rglru", "rglru_scan_fwd", "rglru_scan_fwd", "rglru_scan_oracle")
    _operator_dispatch("rglru", "rglru_scan_bwd", "rglru_scan_bwd", "rglru_scan_bwd_oracle")
    a = torch.full((1, 4, 8), 0.5, requires_grad=True)
    h = ops.rglru_scan(a, torch.zeros(1, 4, 8))
    assert type(h.grad_fn).__name__ == "RGLRUBackward"


def test_ssd_runs_its_backward_kernel_on_the_card():
    """ops.ssd under autograd goes through ops.SSD, whose backward is K2's
    backward kernel on a CUDA tensor: no _no_backward call for ssd is left,
    and SSD dispatches on the device to ssd_fwd/ssd_bwd or their plain
    versions: SSD calls the operators ssd_fwd_saved (the card's forward,
    which keeps the kernel's scratch for the backward) or ssd_fwd, and
    ssd_bwd, which dispatch on the device."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "ops.py").read_text()
    assert '_no_backward("ssd"' not in src and "SSD.apply(x, dt, A, B, C, chunk)" in src
    body = src[src.index("class SSD("):src.index("def ssd(")]
    assert "_ops.ssd_fwd_saved(" in body and "_ops.ssd_fwd(" in body
    assert "_ops.ssd_bwd(" in body
    _operator_dispatch("ssd", "ssd_fwd", "ssd_fwd", "ssd_oracle")
    _operator_dispatch("ssd", "ssd_bwd", "ssd_bwd", "ssd_bwd_oracle")
    assert torch._C._dispatch_has_kernel_for_dispatch_key("repro_torch::ssd_fwd_saved", "CUDA")
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    y, _ = ops.ssd(x, torch.zeros(1, 4, 2), torch.zeros(2), torch.zeros(1, 4, 8),
                   torch.zeros(1, 4, 8))
    assert type(y.grad_fn).__name__ == "SSDBackward"


def test_launch_train_runs_mamba2_on_the_cpu(tmp_path):
    """launch/train.py --arch mamba2-780m --smoke --device cpu: the SSD layers
    train through ops.SSD's plain backward."""
    args = ["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "40", "--batch", "2", "--log-every", "1"]
    log = launch_train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)


def test_launch_train_runs_recurrentgemma_on_the_cpu(tmp_path):
    """launch/train.py --arch recurrentgemma-9b --smoke --device cpu: the
    RG-LRU layers train through ops.RGLRU's plain backward, the local
    layers through ops.FlashAttention's."""
    args = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "40", "--batch", "2", "--log-every", "1"]
    log = launch_train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)


def test_remat_policies_run_and_stay_off_without_grad():
    model = _smoke_model(torch.float32)
    b = make_batch(DataConfig(vocab_size=512, seq_len=40, global_batch=2), 0, "cpu")
    with torch.no_grad():
        losses = {r: model.loss(b, Ctx(remat=r))[0].item() for r in ("none", "dots", "full")}
    assert len(set(losses.values())) == 1
    with pytest.raises(ValueError, match="remat"):
        model.loss(b, Ctx(remat="some"))
