"""Sequence models: attention and the transformer encoder (the port of
``mmlspark_tpu/models/attention.py``).

``dense_attention`` is the reference's attention over ``[B, T, H, D]``
tensors. Where the flash gate (``flash_route``, the counterpart of the
reference's ``_flash_dispatch``) lets it, it runs K5, the hand-written
flash-attention kernel (``flash_kernel.py``, ``csrc/flash_attn.cu``);
everywhere else it runs K5's plain version, the reference's XLA path. The
gate keeps the reference's conditions, with "the backend is a TPU" read as
"the tensors are on a CUDA device", and one difference: the shortest key
length that takes the kernel was measured on the H100, not taken from the
TPU. Every head dim the gate admits (64 or a multiple of 128) runs through
the kernels, forward and backward: above the tuned instantiations (K5 to
512, K6 and K7 to 256) in column slices (``flash_kernel.col_slices``).

Under autograd (grad enabled and an input requiring grad) a call the gate
admits goes through ``flash_kernel.FlashAttention``: K5 forward with the
rows' log-sum-exp, K6 and K7 backward. Everywhere else under autograd the
plain forward is differentiated by autograd, as the reference's XLA route
is by JAX.

The modules mirror the reference's, as ``nn.Module`` layers whose
parameters carry its key names (see ``module.py``): ``LayerNorm``
(``scale``, ``bias``), ``Embed`` (``table``), ``MultiHeadAttention``
(``wq``, ``wk``, ``wv``, ``wo``, each ``[dim, dim]``), ``LSTM`` (``wx``,
``wh``, ``b``) and ``BiLSTM`` (``fwd``, ``bwd``), and the builders
``transformer_block`` (with the switch-MoE FFN of ``moe.py`` under
``moe_experts``), ``transformer_encoder`` and ``bilstm_tagger``.

On a mesh (``module.activation_sharding``): ``MultiHeadAttention`` given
``wq``/``wk``/``wv`` split over the ``tensor`` axis (their columns are
head-major, so a rank holds whole heads) attends on its own heads, through
K5 (K6 and K7 backward) where the gate admits them, and gathers the heads
before ``wo``, column-parallel too. ``ring_attention`` is the reference's
sequence-parallel attention: each rank holds a block of the sequence, the
K/V blocks travel one hop a step around the ``seq`` ring
(``parallel.mesh.ring_shift``, whose backward shifts the gradients back),
and the rows keep a streaming max and denominator in f32. As the
reference's, it is plain arithmetic: no kernel of the reference's runs
there. ``MultiHeadAttention(ring_axis=...)`` runs it on the rank's block of
the sequence.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import flash_kernel
from .moe import MoE
from .module import (Dense, Fn, FunctionModel, Module, Residual, Sequential,
                     _param, _tensor_gather, compute_dtype, current_mesh,
                     matmul)


# ---------------------------------------------------------------------------
# functional attention
# ---------------------------------------------------------------------------


def _kernel_device(q: torch.Tensor) -> bool:
    """The reference's ``jax.default_backend() == "tpu"``: K5 runs on CUDA
    tensors only."""
    return q.device.type == "cuda"


#: the shortest key length that takes K5 unless ``MMLSPARK_TPU_FLASH_MIN_T``
#: says otherwise. The reference's 1024 was the TPU's crossover; on the H100
#: the kernel beats its plain version at every length the gate admits
#: (``chip_smoke.py``'s attn_kernel phase times both from T = 128 up and
#: fails if that stops holding), so the card needs no length condition.
FLASH_MIN_T_DEFAULT = 0


def flash_route(q: torch.Tensor, k: torch.Tensor, causal: bool,
                q_offset: int = 0, k_offset: int = 0) -> bool:
    """Does this call go to K5? The reference's ``_flash_dispatch``
    conditions: bf16 ``q`` on the kernel's device, no shard offsets,
    full-square causal only, Tq and Tk multiples of 128, head dim 64 or a
    multiple of 128, and Tk >= ``MMLSPARK_TPU_FLASH_MIN_T`` (default
    ``FLASH_MIN_T_DEFAULT``). ``MMLSPARK_TPU_NO_FLASH=1`` turns it off."""
    if os.environ.get("MMLSPARK_TPU_NO_FLASH", "") not in ("", "0"):
        return False
    if q.dtype != torch.bfloat16 or not _kernel_device(q):
        return False
    if q_offset or k_offset:
        return False
    _, tq, _, d = q.shape
    tk = k.shape[1]
    if causal and tq != tk:
        return False
    if tq % 128 or tk % 128 or not flash_kernel.head_dim_ok(d):
        return False
    return tk >= int(os.environ.get("MMLSPARK_TPU_FLASH_MIN_T",
                                    FLASH_MIN_T_DEFAULT))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Attention, q: [B, Tq, H, D], k/v: [B, Tk, H, D] -> [B, Tq, H, D].
    ``*_offset`` are global position offsets for causal masking of shards.
    K5 where ``flash_route`` says so (a K5 failure propagates), through
    ``FlashAttention`` (K6 and K7 backward) when autograd records the call;
    else its plain version."""
    if flash_route(q, k, causal, q_offset, k_offset):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_kernel.FlashAttention.apply(q, k, v, causal)
        return flash_kernel.flash_attention(q, k, v, causal)
    return flash_kernel.flash_attention_plain(q, k, v, causal, q_offset,
                                              k_offset)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   causal: bool = False, axis_name: Optional[str] = None
                   ) -> torch.Tensor:
    """Sequence-parallel attention: this rank holds block ``i`` (its
    coordinate on ``axis_name``, default ``seq``) of q/k/v, each
    [B, T_local, H, D]; the K/V blocks go one hop around the ring a step
    while the queries' output accumulates with a streaming softmax (running
    max ``m`` and denominator ``l`` in f32). Rows with no valid key give 0.
    The reference's ``ring_attention`` under ``shard_map``; the backward
    runs through the shifts' reverse. Every rank of the ring calls it."""
    from ..parallel.mesh import SEQ_AXIS, ring_shift

    axis = axis_name or SEQ_AXIS
    size = mesh.axis_size(axis)
    my = mesh.coord(axis)
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    pos = torch.arange(t, device=q.device)
    for step in range(size):
        src = (my - step) % size      # whose K/V block this rank holds now
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(torch.float32)) * scale
        if causal:
            late = (pos[None, :] + src * t) > (pos[:, None] + my * t)
            s = s.masked_fill(late, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) guards: rows with no valid key yet stay 0
        safe = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        p = torch.exp(torch.where(torch.isfinite(s), s - safe[..., None],
                                  torch.full_like(s, -math.inf)))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.to(torch.float32))
        o = o * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if step + 1 < size:          # the last hop would go unused
            kb = ring_shift(kb, mesh, axis)
            vb = ring_shift(vb, mesh, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class LayerNorm(Module):
    """LayerNorm over the last dim: f32 statistics (population variance),
    the input dtype preserved."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def init(self, gen, in_shape):
        d = in_shape[-1]
        self.scale = _param(torch.ones(d))
        self.bias = _param(torch.zeros(d))
        return tuple(in_shape)

    def forward(self, x):
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)

    def extra_repr(self) -> str:
        return f"eps={self.eps}"


class Embed(Module):
    """Token ids [T] -> embeddings [T, dim]. As the reference's ``jnp.take``:
    ids are cast to int32 first, a negative id wraps once (-1 is the last
    row), and an id still out of range gives a NaN row (no device assert)."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim

    def init(self, gen, in_shape):
        table = torch.randn(self.vocab_size, self.dim, generator=gen) \
            * torch.tensor(0.02, dtype=torch.float32)
        self.table = _param(table)
        return tuple(in_shape) + (self.dim,)

    def forward(self, x):
        idx = x.to(torch.int32).to(torch.int64)
        idx = torch.where(idx < 0, idx + self.vocab_size, idx)
        ok = (idx >= 0) & (idx < self.vocab_size)
        rows = self.table[torch.where(ok, idx, torch.zeros_like(idx))]
        return rows.masked_fill(~ok[..., None], math.nan)

    def extra_repr(self) -> str:
        return f"vocab_size={self.vocab_size}, dim={self.dim}"


class MultiHeadAttention(Module):
    """Self-attention on [B, T, D]: projections in ``matmul_dtype()`` with
    f32 products, rounded back to that dtype for the attention, which runs
    through ``dense_attention`` (K5 where the gate allows); the output
    projection returns f32. ``ring_axis``: ``ring_attention`` over that
    axis of the enclosing mesh (``activation_sharding``), T then being the
    rank's block of the sequence. ``wq``/``wk``/``wv`` split over
    ``tensor`` (whole heads a rank) attend on the rank's heads, which are
    gathered before ``wo``; a split ``wo`` runs column-parallel."""

    def tensor_parallel(self, tensor: int):
        """The parameters a mesh step may hand over split over a tensor
        axis of ``tensor`` ranks: ``wo`` always, the projections of q, k, v
        when every rank gets whole heads."""
        if self.num_heads % tensor:
            return ("wo",)
        return ("wq", "wk", "wv", "wo")

    def __init__(self, num_heads: int, causal: bool = False,
                 ring_axis: Optional[str] = None,
                 ring_axis_size: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.ring_axis = ring_axis
        self.ring_axis_size = ring_axis_size

    def init(self, gen, in_shape):
        t, d = in_shape
        if d % self.num_heads:
            raise ValueError(f"dim {d} not divisible by heads {self.num_heads}")
        std = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(torch.randn(d, d, generator=gen) * std))
        return (t, d)

    def forward(self, x):
        dt = compute_dtype()
        b, t, d = x.shape
        dh = d // self.num_heads

        def proj(w):
            # a rank's columns of a tensor-split projection are its heads
            return matmul(x, w, dt).reshape(b, t, w.shape[-1] // dh, dh) \
                .to(dt)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if self.ring_axis is not None:
            mesh = current_mesh()
            if mesh is None:
                raise ValueError("ring_axis runs under "
                                 "activation_sharding(mesh) only")
            o = ring_attention(q, k, v, mesh, self.causal, self.ring_axis)
        else:
            o = dense_attention(q, k, v, causal=self.causal)
        o = o.reshape(b, t, -1)
        if o.shape[-1] != d:
            o = _tensor_gather(o)           # every head, before wo
        out = matmul(o, self.wo, dt)
        if self.wo.shape[-1] != d:
            out = _tensor_gather(out)
        return out.to(torch.float32)

    def extra_repr(self) -> str:
        ring = f", ring_axis={self.ring_axis!r}" if self.ring_axis else ""
        return f"num_heads={self.num_heads}, causal={self.causal}{ring}"


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _same_shape(s):
    return s


def transformer_block(dim: int, num_heads: int, mlp_ratio: int = 4,
                      causal: bool = False, ring_axis: Optional[str] = None,
                      ring_axis_size: Optional[int] = None,
                      moe_experts: Optional[int] = None,
                      moe_capacity_factor: float = 1.5) -> Sequential:
    """Pre-norm transformer block as a named Sequential (taps work).
    ``moe_experts``: a switch-MoE of that many experts in place of the dense
    FFN (``moe.MoE``; its experts split over a mesh's ``expert`` axis by
    ``moe.expert_shardings``)."""
    attn = Sequential([
        ("ln", LayerNorm()),
        ("attn", MultiHeadAttention(num_heads, causal=causal,
                                    ring_axis=ring_axis,
                                    ring_axis_size=ring_axis_size)),
    ])
    if moe_experts:
        mlp = Sequential([
            ("ln", LayerNorm()),
            ("moe", MoE(moe_experts, hidden=dim * mlp_ratio,
                        capacity_factor=moe_capacity_factor)),
        ])
    else:
        mlp = Sequential([
            ("ln", LayerNorm()),
            ("fc1", Dense(dim * mlp_ratio)),
            ("gelu", Fn(_gelu, _same_shape)),
            ("fc2", Dense(dim)),
        ])
    return Sequential([
        ("attn", Residual(attn, activation=None)),
        ("mlp", Residual(mlp, activation=None)),
    ])


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def transformer_encoder(seq_len: int, dim: int, depth: int, num_heads: int,
                        vocab_size: Optional[int] = None,
                        num_classes: Optional[int] = None,
                        causal: bool = False,
                        ring_axis: Optional[str] = None,
                        ring_axis_size: Optional[int] = None,
                        seed: int = 0) -> FunctionModel:
    """Named-layer transformer encoder as a FunctionModel (taps address
    "block3", "block3/mlp/body/fc1", ...). Parameters are drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed`` (other numbers than the
    reference's ``jax.random``; ``convert.load_jax_params`` carries the
    reference's weights over). ``ring_axis``: the blocks attend by
    ``ring_attention`` over that mesh axis, each rank holding a block of
    the sequence (run under ``activation_sharding(mesh)``)."""
    layers = []
    if vocab_size is not None:
        layers.append(("embed", Embed(vocab_size, dim)))
        in_shape: Tuple[int, ...] = (seq_len,)
    else:
        in_shape = (seq_len, dim)
    for i in range(depth):
        layers.append((f"block{i}", transformer_block(
            dim, num_heads, causal=causal, ring_axis=ring_axis,
            ring_axis_size=ring_axis_size)))
    layers.append(("ln_f", LayerNorm()))
    if num_classes is not None:
        layers.append(("head", Dense(num_classes)))
    module = Sequential(layers, name="transformer")
    module.init(torch.Generator().manual_seed(seed), in_shape)
    layer_names = [name for name, _ in reversed(layers)]
    return FunctionModel(module, in_shape, layer_names, "transformer")


class LSTM(Module):
    """Unidirectional LSTM: [B, T, D] -> [B, T, H], all in f32 as the
    reference's (its ``lax.scan`` is a loop over T here; ``reverse`` runs
    it from the last step). The input projection is hoisted out of the
    loop: one product over all steps. Gates in the order i, f, g, o."""

    def __init__(self, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse

    def init(self, gen, in_shape):
        t, d = in_shape
        h = self.hidden
        std_x = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
        std_h = torch.tensor(1.0 / math.sqrt(h), dtype=torch.float32)
        self.wx = _param(torch.randn(d, 4 * h, generator=gen) * std_x)
        self.wh = _param(torch.randn(h, 4 * h, generator=gen) * std_h)
        self.b = _param(torch.zeros(4 * h))
        return (t, h)

    def forward(self, x):
        b, t, _ = x.shape
        h = self.hidden
        xp = (torch.matmul(x.to(torch.float32), self.wx) + self.b)
        hh = torch.zeros(b, h, dtype=torch.float32, device=x.device)
        c = torch.zeros_like(hh)
        ys = [None] * t
        for step in (range(t - 1, -1, -1) if self.reverse else range(t)):
            gates = xp[:, step] + hh @ self.wh
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            hh = torch.sigmoid(o) * torch.tanh(c)
            ys[step] = hh
        return torch.stack(ys, dim=1)

    def extra_repr(self) -> str:
        return f"hidden={self.hidden}, reverse={self.reverse}"


class BiLSTM(Module):
    """Concat of a forward and a backward LSTM: [B, T, D] -> [B, T, 2H]."""

    def __init__(self, hidden: int):
        super().__init__()
        self.fwd = LSTM(hidden)
        self.bwd = LSTM(hidden, reverse=True)

    def init(self, gen, in_shape):
        t, h = self.fwd.init(gen, in_shape)
        self.bwd.init(gen, in_shape)
        return (t, 2 * h)

    def forward(self, x):
        return torch.cat([self.fwd(x), self.bwd(x)], dim=-1)


def bilstm_tagger(seq_len: int, vocab_size: int, embed_dim: int,
                  hidden: int, num_tags: int, seed: int = 0) -> FunctionModel:
    """Embed -> BiLSTM -> per-token tag logits, as a FunctionModel (the
    reference's medical entity extraction architecture). Parameters from a
    ``torch.Generator`` seeded with ``seed`` (``convert.load_jax_params``
    carries the reference's over)."""
    module = Sequential([
        ("embed", Embed(vocab_size, embed_dim)),
        ("bilstm", BiLSTM(hidden)),
        ("tags", Dense(num_tags)),
    ], name="bilstm_tagger")
    module.init(torch.Generator().manual_seed(seed), (seq_len,))
    return FunctionModel(module, (seq_len,), ["tags", "bilstm", "embed"],
                         "bilstm_tagger")
