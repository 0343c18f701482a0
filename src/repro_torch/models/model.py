"""Model assembly and serving API (counterpart of ``repro/models/model.py``).

Structure: embed -> [encoder (enc-dec only)] -> layers (superblock x repeat
+ remainder, unrolled into one list) -> final norm -> unembed. Each layer is
a residual block: ln -> mixer (attention global | local | cross, the Mamba2
SSD block or the RG-LRU block) [-> ln_x -> gated cross-attention to the
encoder's output, in an enc-dec model's global layers] [-> ln -> gated MLP,
or the MoE layer when the config has experts (a cross layer keeps the MLP),
when d_ff > 0]. The encoder of an enc-dec model is ``encoder_layers``
bidirectional ``enc`` layers over the stub frontend's memory, then a final
norm; a vlm's cross layers attend to the memory itself.

Parameters keep the JAX package's layouts and nesting; the JAX stack of
superblock layers (leading ``layers`` axis) becomes one ``ParamTree`` per
layer, layer r*len(superblock)+i for slot i of repeat r, then the
remainder; the JAX encoder stack (``encoder.sb.slot0``) becomes
``encoder.layers.N``. ``bridge.from_jax_params`` maps one onto the other.

API: apply (full-sequence logits, and on request the MoE aux loss summed
over the layers), loss (next-token CE + z-loss + 0.01 aux), prefill
(last-position logits + decode cache), init_cache, decode_step (one token),
memory_len. An arch with ``memory_len() > 0`` takes the stub frontend's
memory (B, memory_len, D) in apply, loss (``batch["memory"]``) and prefill;
decode reads the cross layers' k/v from the cache prefill wrote.

Under autograd each repeat of the superblock, and each encoder layer, can
be rematerialized (``Ctx.remat``, the counterpart of ``_maybe_remat``):
``full`` saves only its input and recomputes the rest in the backward;
``dots`` also saves the outputs of the weight products. The remainder
layers are never rematted, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTENTION_KINDS, CROSS_ATTN, ENC_ATTN,
                                      GLOBAL_ATTN, RGLRU, SSD, ModelConfig,
                                      ParallelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models.layers import (ParamSpec, ParamTree, embed_apply,
                                       embed_specs, first_index, mlp_apply, mlp_specs,
                                       rms_norm, rms_norm_specs, unembed_apply)

class _Mixer(NamedTuple):
    """The functions of a recurrent mixer block."""
    specs: Callable
    apply: Callable
    decode: Callable
    cache_specs: Callable


_MIXERS = {
    SSD: _Mixer(ssm.ssd_specs, ssm.ssd_block_apply, ssm.ssd_block_decode,
                ssm.init_ssd_cache),
    RGLRU: _Mixer(rglru.rglru_specs, rglru.rglru_block_apply,
                  rglru.rglru_block_decode, rglru.init_rglru_cache),
}


@dataclasses.dataclass
class Ctx:
    """Per-call context, the counterpart of the JAX package's ``Ctx``: the
    remat policy of the superblock body under autograd (none | dots | full)
    and the sharding hook. ``shard_fn(x, axes)`` is None without a mesh;
    under one it is ``parallel.sharding.make_shard_fn``'s, which
    redistributes an activation to what its logical axes resolve to (the
    counterpart of ``with_sharding_constraint``). ``moe_groups``: the MoE
    layers' dispatch groups, each routed with its own capacity (the
    data-parallel degree under a mesh, ``train_step.make_ctx``). The port
    has one implementation of each mixer, so it has no ``attn_impl``."""
    remat: str = "none"
    shard_fn: Callable | None = None
    moe_groups: int = 1

    def shard(self, x, *axes):
        if self.shard_fn is None:
            return x
        return self.shard_fn(x, axes)


# ---------------------------------------------------------------------------
# per-layer specs / apply
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig, kind: str):
    d = cfg.d_model
    s: dict = {"ln1": rms_norm_specs(d, ("embed",))}
    if kind in _MIXERS:
        s["mixer"] = _MIXERS[kind].specs(cfg)
    elif kind in ATTENTION_KINDS:
        s["attn"] = attn.attention_specs(cfg, cross=kind == CROSS_ATTN)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.is_encdec and kind == GLOBAL_ATTN:
        s["ln_x"] = rms_norm_specs(d, ("embed",))
        s["xattn"] = attn.attention_specs(cfg, cross=True)
    if cfg.d_ff:
        s["ln2"] = rms_norm_specs(d, ("embed",))
        if cfg.num_experts and kind != CROSS_ATTN:
            s["moe"] = moe.moe_specs(cfg)
        else:
            s["mlp"] = mlp_specs(d, cfg.d_ff)
    return s


def _feed_forward(p, h, cfg, ctx):
    """h + the gated MLP or the MoE layer of rms_norm(h). Returns (h, aux):
    the MoE aux loss, or 0.0 where the layer has no experts."""
    m_in = rms_norm(h, p["ln2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        m, aux = moe.moe_apply(p["moe"], m_in, cfg, ctx)
        return h + m, aux
    return h + mlp_apply(p["mlp"], m_in, cfg.act, ctx), 0.0


def apply_layer(p, h, kind, cfg, ctx, memory=None, positions=None,
                collect_cache=False, cache_len=0):
    """Residual block.  Returns (h, aux_loss, cache|None); aux_loss is 0.0
    where the layer has no experts. ``memory``: what a cross layer, or the
    cross-attention sub-layer of an enc-dec global layer, attends to."""
    a_in = rms_norm(h, p["ln1"]["scale"], cfg.norm_eps)
    cache = {}
    if kind in _MIXERS:
        out, c = _MIXERS[kind].apply(p["mixer"], a_in, cfg, ctx, collect_cache)
        cache["mixer"] = c
    else:
        out, (k, v) = attn.attention_apply(
            p["attn"], a_in, cfg, ctx, kind,
            memory=memory if kind == CROSS_ATTN else None, positions=positions)
        if collect_cache:
            cache["attn"] = attn.pack_prefill_cache(k, v, kind, cfg, cache_len)
    h = h + out
    if "xattn" in p and memory is not None:
        x_in = rms_norm(h, p["ln_x"]["scale"], cfg.norm_eps)
        out, (xk, xv) = attn.attention_apply(p["xattn"], x_in, cfg, ctx, CROSS_ATTN,
                                             memory=memory)
        if collect_cache:
            cache["xattn"] = attn.pack_prefill_cache(xk, xv, CROSS_ATTN, cfg, 0)
        h = h + out
    aux = 0.0
    if cfg.d_ff:
        h, aux = _feed_forward(p, h, cfg, ctx)
    h = ctx.shard(h, "batch", "seq", "embed")
    return h, aux, (cache if collect_cache else None)


def apply_layer_decode(p, h, layer_cache, pos, kind, cfg, ctx):
    """One-token residual block.  h (B,1,D).  Returns (h, layer_cache),
    the cache updated in place; the MoE aux loss is dropped, as in the JAX
    package."""
    a_in = rms_norm(h, p["ln1"]["scale"], cfg.norm_eps)
    if kind in _MIXERS:
        out, _ = _MIXERS[kind].decode(p["mixer"], a_in, layer_cache["mixer"], cfg, ctx)
    else:
        out, _ = attn.attention_decode(p["attn"], a_in, layer_cache["attn"],
                                       pos, cfg, ctx, kind)
    h = h + out
    if "xattn" in p:
        x_in = rms_norm(h, p["ln_x"]["scale"], cfg.norm_eps)
        out, _ = attn.attention_decode(p["xattn"], x_in, layer_cache["xattn"], pos,
                                       cfg, ctx, CROSS_ATTN)
        h = h + out
    if cfg.d_ff:
        h, _ = _feed_forward(p, h, cfg, ctx)
    h = ctx.shard(h, "batch", "seq", "embed")
    return h, layer_cache


def init_layer_cache_specs(cfg, kind, batch, cache_len):
    """ParamSpec tree for one layer's decode cache; an enc-dec global layer
    also keeps its cross-attention sub-layer's k/v of the encoder's output."""
    if kind in _MIXERS:
        c = {"mixer": _MIXERS[kind].cache_specs(cfg, batch)}
    else:
        c = {"attn": attn.attn_cache_specs(cfg, kind, batch, cache_len)}
    if cfg.is_encdec and kind == GLOBAL_ATTN:
        c["xattn"] = attn.attn_cache_specs(cfg, CROSS_ATTN, batch, cache_len)
    return c


def _materialize(specs, device):
    if isinstance(specs, ParamSpec):
        return specs.materialize(None, device)
    return {k: _materialize(s, device) for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The decoder with its parameters, seeded from ``seed`` on ``device``
    (``None`` means ``cuda``; the CPU only when asked for). Parameters
    require grad only when ``trainable``; serving leaves them frozen.
    ``apply`` shadows ``nn.Module.apply`` on purpose, to keep the JAX
    package's API names. With ``abstract`` the parameters are empty, with
    no init (``abstract_from_specs``): made inside a FakeTensorMode they are
    fake, so a model of any width and depth takes no memory, on ``device``
    whether or not a card is present, and a trace of it
    (``core.capture.capture_step``) launches nothing."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 trainable: bool = False, abstract: bool = False):
        super().__init__()
        if abstract:
            device = _abstract_device(device)
            g = None
        else:
            device = resolve_device(device)
            g = torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        tree = functools.partial(ParamTree, generator=g, device=device,
                                 trainable=trainable, abstract=abstract)
        self.embed = tree(embed_specs(cfg.vocab_size, cfg.d_model))
        self.final_norm = tree(rms_norm_specs(cfg.d_model, ("embed",)))
        if not cfg.tie_embeddings:
            self.unembed = tree({"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                                                    ("vocab", "embed"))})
        self.layers = nn.ModuleList(tree(layer_specs(cfg, kind))
                                    for kind in cfg.layer_kinds)
        if cfg.is_encdec:
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(tree(layer_specs(cfg, ENC_ATTN))
                                                for _ in range(cfg.encoder_layers))
            self.encoder.final_norm = tree(rms_norm_specs(cfg.d_model, ("embed",)))

    def param_specs(self) -> dict[str, ParamSpec]:
        """{parameter name: its ParamSpec}, the logical axes those of the JAX
        package's spec without the leading ``layers`` axis of a stacked
        layer."""
        return {f"{mod_name}.{key}": spec
                for mod_name, mod in self.named_modules()
                if isinstance(mod, ParamTree) for key, spec in mod.param_specs.items()}

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _table(self):
        return (self.embed if self.cfg.tie_embeddings else self.unembed)["table"]

    def _check_memory(self, tokens, memory):
        """The stub frontend's memory (B, memory_len, D) where the arch
        attends to one, and none where it does not."""
        n = self.memory_len()
        if not n:
            if memory is not None:
                raise ValueError(f"{self.cfg.name} attends to no memory; got one")
            return
        if memory is None:
            raise ValueError(f"{self.cfg.name} needs the stub frontend's memory "
                             f"(B, {n}, {self.cfg.d_model})")
        if memory.dim() != 3 or memory.shape[0] != tokens.shape[0] \
                or memory.shape[2] != self.cfg.d_model:
            raise ValueError(f"memory must be (B={tokens.shape[0]}, M, "
                             f"{self.cfg.d_model}); got {tuple(memory.shape)}")

    def encode(self, memory, ctx=None):
        """The encoder of an enc-dec model over the stub frontend's memory
        (B, M, D), taken in the parameters' dtype (the JAX scan carries it
        in that dtype): its ``enc`` layers, each rematted as the decoder's
        superblock repeats are, then its final norm."""
        cfg, ctx = self.cfg, ctx or Ctx()
        h = memory.to(self.embed["table"].dtype)

        def layer(h, i):
            return apply_layer(self.encoder.layers[i], h, ENC_ATTN, cfg, ctx)[0]

        remat = _maybe_remat(layer, ctx) or layer
        for i in range(cfg.encoder_layers):
            h = remat(h, i)
        return rms_norm(h, self.encoder.final_norm["scale"], cfg.norm_eps)

    def _trunk(self, tokens, ctx, memory=None, collect_cache=False, cache_len=0):
        """Embed, [encode,] all layers, final norm: (h (B,S,D), per-layer
        caches, the MoE aux loss summed over the layers (0.0 without
        experts))."""
        cfg = self.cfg
        ctx = ctx or Ctx()
        self._check_memory(tokens, memory)
        if cfg.is_encdec:
            memory = self.encode(memory, ctx)
        h = embed_apply(self.embed, tokens, cfg.d_model, ctx)
        h = ctx.shard(h, "batch", "seq", "embed")
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        caches = []

        nsb = len(cfg.superblock)

        def layer(i, h, memory):
            h, aux, c = apply_layer(self.layers[i], h, cfg.layer_kinds[i], cfg, ctx,
                                    memory=memory, positions=positions,
                                    collect_cache=collect_cache, cache_len=cache_len)
            caches.append(c)
            return h, aux

        def superblock(h, r, memory):
            aux = 0.0
            for i in range(r * nsb, (r + 1) * nsb):
                h, a = layer(i, h, memory)
                aux = aux + a
            return h, aux

        # rematted repeats first; then every other layer one by one, so that
        # no layer's input outlives the layer where nothing is rematted
        remat = None if collect_cache else _maybe_remat(superblock, ctx)
        start, aux = 0, 0.0
        if remat is not None:
            for r in range(cfg.sb_repeat):
                h, a = remat(h, r, memory)
                aux = aux + a
            start = nsb * cfg.sb_repeat
        for i in range(start, cfg.num_layers):
            h, a = layer(i, h, memory)
            aux = aux + a
        return rms_norm(h, self.final_norm["scale"], cfg.norm_eps), caches, aux

    # -- full-sequence forward ----------------------------------------------
    def apply(self, tokens, ctx=None, memory=None, return_aux=False):
        """tokens (B,S) -> logits (B,S,V) f32; with ``return_aux`` (logits,
        the MoE aux loss summed over the layers as an f32 scalar), as the
        JAX package's apply returns them. ``memory``: the stub frontend's
        embeddings (B, memory_len(), D), which an arch with cross-attention
        needs."""
        h, _, aux = self._trunk(tokens, ctx, memory)
        logits = unembed_apply(self._table(), h, self.cfg.logits_soft_cap, ctx)
        if not return_aux:
            return logits
        return logits, torch.as_tensor(aux, dtype=torch.float32, device=logits.device)

    def forward(self, tokens, ctx=None, memory=None):
        return self.apply(tokens, ctx, memory)

    # -- loss ----------------------------------------------------------------
    def loss(self, batch, ctx=None):
        """batch: {tokens (B,S), labels (B,S) (-1 = pad), [memory]}. Returns
        (total, {ce, aux, zloss, ntok}): next-token CE over f32 logits, a
        1e-4 z-loss on the log normalizer, and 0.01 times the MoE aux loss
        summed over the layers (0 without experts). The label logit is
        gathered, which gives the same numbers as the JAX package's
        gather-free select-and-sum."""
        logits, aux = self.apply(batch["tokens"], ctx, batch.get("memory"),
                                 return_aux=True)
        logits = logits.float()
        labels = batch["labels"]
        if isinstance(logits, DTensor):
            lse, sel = sharded_lse_and_label_logit(logits, labels)
        else:
            lse = torch.logsumexp(logits, dim=-1)                     # (B,S)
            sel = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        nll = lse - sel
        mask = (labels >= 0).float()
        ntok = mask.sum().clamp_min(1.0)
        ce = (nll * mask).sum() / ntok
        zloss = 1e-4 * (lse.square() * mask).sum() / ntok
        total = ce + zloss + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "zloss": zloss, "ntok": ntok}

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, tokens, cache_len, ctx=None, memory=None):
        """Full forward + packed decode cache.  Returns (last_logits (B,V),
        cache). Only the last position is unembedded: the same numbers as
        apply(tokens)[:, -1] without a (B,S,V) buffer. The cross layers'
        caches hold the k/v of ``memory`` (of the encoder's output)."""
        h, caches, _ = self._trunk(tokens, ctx, memory, collect_cache=True,
                                   cache_len=cache_len)
        logits = unembed_apply(self._table(), h[:, -1:], self.cfg.logits_soft_cap, ctx)
        return logits[:, 0], {"pos": tokens.shape[1], "layers": caches}

    def cache_specs(self, batch, cache_len):
        """The ParamSpec tree of each layer's decode cache."""
        return [init_layer_cache_specs(self.cfg, kind, batch, cache_len)
                for kind in self.cfg.layer_kinds]

    def init_cache(self, batch, cache_len, *, mesh=None, parallel=None):
        """An empty decode cache; under a mesh (a model sharded by
        ``parallel.sharding.shard_model``) each rank makes only its shard,
        placed by the cache rules of ``parallel`` (``sharding.init_cache``)."""
        if mesh is not None:
            # imported here: parallel.sharding imports the models package
            from repro_torch.parallel import sharding
            return sharding.init_cache(self, batch, cache_len, mesh,
                                       parallel or ParallelConfig())
        return {"pos": 0, "layers": [_materialize(s, self.device)
                                     for s in self.cache_specs(batch, cache_len)]}

    def decode_step(self, token, cache, ctx=None):
        """token (B,1) int; cache from init_cache/prefill, updated in place.

        Returns (logits (B,V), cache with pos advanced by one). Under a mesh
        (``ctx.shard_fn`` set, the model sharded) the token and the cache may
        be placed or whole; each layer's cache is placed by the cache rules at
        its first step (``attention.attention_decode``), and the logits come
        back as a DTensor split over the vocab."""
        cfg = self.cfg
        ctx = ctx or Ctx()
        pos = cache["pos"]
        h = embed_apply(self.embed, token, cfg.d_model, ctx)
        h = ctx.shard(h, "batch", "seq", "embed")
        for p, kind, c in zip(self.layers, cfg.layer_kinds, cache["layers"]):
            h, _ = apply_layer_decode(p, h, c, pos, kind, cfg, ctx)
        h = rms_norm(h, self.final_norm["scale"], cfg.norm_eps)
        logits = unembed_apply(self._table(), h, cfg.logits_soft_cap, ctx)[:, 0]
        return logits, {"pos": pos + 1, "layers": cache["layers"]}

    def stacked_ndims(self) -> dict:
        """{parameter name: its ndim in the JAX package's layout}, where the
        superblock's layers and the encoder's are stacked on a leading
        ``layers`` axis: one more than the port's for those layers. AdamW
        decays leaves of ndim >= 2, so in both packages the vectors of
        stacked layers (norm scales, biases) decay and those of the
        remainder layers do not; a stacked cross gate has ndim 1 and does
        not decay."""
        stacked = len(self.cfg.superblock) * self.cfg.sb_repeat
        out = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            out[name] = p.dim() + ((parts[0] == "layers" and int(parts[1]) < stacked)
                                   or parts[:2] == ["encoder", "layers"])
        return out

    def memory_len(self):
        """Length of the stub frontend's memory: the image tokens of a vlm,
        the encoder's frames of an enc-dec model, else 0."""
        if self.cfg.family == "vlm":
            return self.cfg.context_tokens
        if self.cfg.is_encdec:
            return self.cfg.encoder_len
        return 0


def sharded_lse_and_label_logit(logits, labels):
    """The logsumexp over the vocab of f32 logits (B, S, V), a DTensor
    whose vocab may be split over mesh dims, and the logit of each label
    (-1 for padding reads row 0), both (B, S) DTensors placed as the logits'
    rows, as GSPMD computes them: each rank's max, sum of exp and label
    logit over its rows of the vocab (0 where it does not hold the label),
    reduced over the vocab's shards. Left to DTensor, the label's lookup
    gathers the whole logits on every rank, and its backward builds their
    whole gradient there."""
    mesh = logits.device_mesh
    split = [p == Shard(2) for p in logits.placements]
    rows = [Replicate() if v else p for v, p in zip(split, logits.placements)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    labels = labels.redistribute(mesh, rows).to_local()
    x = logits.to_local(grad_placements=logits.placements)

    def reduced(local, op):
        return DTensor.from_local(local, mesh, [Partial(op) if v else p for v, p in
                                                zip(split, rows)],
                                  run_check=False).redistribute(mesh, rows)

    m = reduced(x.detach().amax(dim=-1), "max")
    lse = torch.log(reduced(torch.exp(x - m.to_local()[..., None]).sum(dim=-1), "sum")) + m
    idx = labels.clamp_min(0).long() - first_index(logits, 2)
    keep = (idx >= 0) & (idx < x.shape[-1])
    sel = x.gather(-1, idx.clamp(0, x.shape[-1] - 1)[..., None])[..., 0] * keep.to(x.dtype)
    return lse, reduced(sel, "sum")


def _abstract_device(device) -> torch.device:
    """The device of an abstract model: any, but only inside a
    FakeTensorMode (nothing of the model can run). A fake ``cuda`` model
    needs no card but a build of PyTorch with CUDA: indexing asks the device
    for a guard even for a fake tensor, and autograd for its stream, which a
    build without CUDA does not have (autograd aborts the process there)."""
    dev = torch.device("cuda" if device is None else device)
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("an abstract model has fake parameters: make it inside a "
                           "FakeTensorMode (core.capture.fake_mode())")
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("this build of PyTorch has no CUDA, so it cannot trace a model "
                           "on a fake cuda device: pass device='cpu' here, or trace on a "
                           "build with CUDA (no card needed)")
    return dev


def _save_weight_products(ctx, op, *args, **kwargs):
    """``dots``: keep the outputs of products with no batch dimensions (the
    weight products: mm, addmm, and the bmm with a batch of one that einsum
    makes of them), as ``checkpoint_dots_with_no_batch_dims`` does; recompute
    everything else. The MoE router's product is such a bmm and is kept; the
    expert products are bmm over the expert batch and are recomputed, as
    under the JAX policy, where their expert dimension is a batch dimension
    (also where a rank of a mesh holds one expert: ``moe.expert_products``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1
            and not moe.in_expert_products()):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(body, ctx):
    """One superblock repeat ``body(h, r)`` wrapped in the remat policy, or
    None where nothing is rematted: remat none, or no autograd (nothing is
    saved then)."""
    if ctx.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be none, dots or full; got {ctx.remat!r}")
    if ctx.remat == "none" or not torch.is_grad_enabled():
        return None
    if ctx.remat == "full":
        return lambda *a: checkpoint(body, *a, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_weight_products)
    return lambda *a: checkpoint(body, *a, use_reentrant=False, context_fn=context_fn)
