"""Switch (top-1) mixture-of-experts FFN on one device (the port of
``mmlspark_tpu/models/moe.py``).

The reference's dispatch as dense products, ported as it is:

  - router: tokens [B, T, D] -> f32 logits [B, T, E], softmax, the top-1
    expert per token (``argmax``: the first index on ties) and its
    probability as the gate;
  - dispatch: a [B, T, E, C] one-hot capacity mask, C = ceil(T * cf / E):
    the first C tokens of each expert keep their slot, the rest drop;
    contracted against the tokens into per-expert buffers [E, B, C, D];
  - expert FFN: ``relu(buf @ W1[e]) @ W2[e]`` with operands rounded to
    ``matmul_dtype()`` and f32 sums;
  - combine: the same mask scatters the expert outputs back to their
    tokens, scaled by the gate.

A token's position in its expert's buffer is a prefix count over T, taken
in int64 (exact, and deterministic on the card, where training runs
PyTorch's deterministic algorithms). A gather formulation that skips the
dense mask is later work.

Expert parallelism: ``expert_shardings`` splits the leading E dim of
``w1``/``w2`` over the mesh's ``expert`` axis and keeps the router whole.
Under ``module.activation_sharding(mesh)`` a ``MoE`` given a rank's block
of experts routes every token as on one device (the same capacity and
drops), fills and runs its own experts' buffers, and sums the combine over
the expert group: the reference's batch is not split over ``expert``, and
each token has one expert, so the sum adds zeros to one term.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .module import Module, _param, compute_dtype, current_mesh, matmul


class MoE(Module):
    """Top-1 (switch) MoE FFN on [B, T, D] tokens: ``router`` [D, E], ``w1``
    [E, D, H], ``w2`` [E, H, D] (the reference's keys and shapes)."""

    def __init__(self, num_experts: int, hidden: Optional[int] = None,
                 capacity_factor: float = 1.5):
        super().__init__()
        self.num_experts = num_experts
        self.hidden = hidden
        self.capacity_factor = capacity_factor

    def init(self, gen, in_shape):
        t, d = in_shape
        h = self.hidden or 4 * d
        e = self.num_experts

        def normal(shape, fan_in):
            return torch.randn(*shape, generator=gen) \
                * torch.tensor(1.0 / math.sqrt(fan_in), dtype=torch.float32)

        self.router = _param(normal((d, e), d))
        self.w1 = _param(normal((e, d, h), d))
        self.w2 = _param(normal((e, h, d), h))
        return (t, d)

    def _capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(
            tokens * self.capacity_factor / self.num_experts)))

    def routing(self, x: torch.Tensor):
        """(expert [B, T] int64, gate [B, T] f32, dispatch [B, T, E, C] f32)
        of tokens ``x`` [B, T, D]."""
        e = self.num_experts
        c = self._capacity(x.shape[1])
        logits = torch.matmul(x.to(torch.float32), self.router)
        probs = torch.softmax(logits, dim=-1)
        gate = probs.amax(dim=-1)
        expert = torch.argmax(probs, dim=-1)
        onehot = F.one_hot(expert, e)                              # [B, T, E]
        # position of each token within its expert's buffer; >= C drops
        pos = (torch.cumsum(onehot, dim=1) * onehot - 1).to(torch.float32)
        keep = (pos >= 0) & (pos < c)
        slots = torch.arange(c, dtype=torch.float32, device=x.device)
        dispatch = ((pos[..., None] == slots) & keep[..., None]).to(torch.float32)
        return expert, gate, dispatch

    def forward(self, x):
        b, t, d = x.shape
        dt = compute_dtype()
        _, gate, dispatch = self.routing(x)
        e = self.w1.shape[0]                  # this rank's experts
        mesh = None
        if e != self.num_experts:
            from ..parallel.mesh import EXPERT_AXIS

            mesh = current_mesh()
            if mesh is None:
                raise ValueError("a MoE split over experts runs under "
                                 "activation_sharding(mesh) only")
            first = mesh.coord(EXPERT_AXIS) * e
            dispatch = dispatch[:, :, first:first + e]
        c = dispatch.shape[-1]
        disp = dispatch.reshape(b, t, e * c)                       # [B, T, E*C]
        # [B, T, E, C] x [B, T, D] -> expert buffers [E, B, C, D]
        buf = torch.matmul(disp.transpose(1, 2), x.to(torch.float32))
        buf = buf.reshape(b, e, c, d).transpose(0, 1)
        hmid = torch.relu(matmul(buf, self.w1[:, None], dt))      # [E, B, C, H]
        out_buf = matmul(hmid, self.w2[:, None], dt)              # [E, B, C, D]
        # combine back to token positions, gate-scaled
        combined = torch.matmul(disp, out_buf.transpose(0, 1).reshape(b, e * c, d))
        if mesh is not None:
            from ..parallel.mesh import EXPERT_AXIS, all_reduce_axis

            combined = all_reduce_axis(combined, mesh, EXPERT_AXIS)
        return combined * gate[..., None]

    def extra_repr(self) -> str:
        return (f"num_experts={self.num_experts}, hidden={self.hidden}, "
                f"capacity_factor={self.capacity_factor}")


def expert_shardings(mesh, params):
    """A ``ShardSpec`` tree mirroring ``params``: the expert-indexed leaves
    (``w1``/``w2``) split their leading E dim over ``expert``, everything
    else whole (``parallel.mesh.shard_tree(params, ..., mesh)`` gives a
    rank's block)."""
    from ..parallel.mesh import EXPERT_AXIS, ShardSpec

    def place(tree):
        return {k: place(v) if isinstance(v, dict) else
                ShardSpec((EXPERT_AXIS,) if k in ("w1", "w2") else (), mesh)
                for k, v in tree.items()}

    return place(params)
