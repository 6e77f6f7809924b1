"""Pipeline-parallel (staged) embed: GPipe-style microbatch schedule.

Port of the JAX package's ``parallel/pipeline_staged.py``. The fast embed's
chain is split over three ranks, so that different ranks work on different
microbatches' stages at once:

    stage 0: u8 RGB -> integer luma -> first DCT-II pass  (kernel K1)
    stage 1: second pass -> rank -> modulate -> (delta, idx)
    stage 2: sparse delta-IDCT added to the u8 image      (kernel K4)

Activations move point to point, each only along the edge that consumes
it: stage 0 sends stage 1 the (B, H, W) bf16 half-transformed plane, stage
1 sends stage 2 the (B, n) delta and indices. The schedule is the textbook
GPipe fill-drain: with M microbatches and S stages, M + S - 1 ticks, stage
``s`` working on microbatch ``t - s`` at tick ``t``; bubble fraction
(S-1)/(M+S-1).

The stage bodies ARE the single-device fast path's (``pipeline._half_pass``,
``pipeline._rank_from_half`` and the modulation, and ``embed_epilogue(rgb,
delta, idx)``, exactly what ``pipeline._embed_fast`` calls), so the staged
result is bit-equal to ``pipeline.embed`` per microbatch: an execution
schedule, not a numerics fork.

The JAX package records this schedule as a negative result: 2.9x slower
than data parallelism on the same devices (its README). PP moves a
half-plane per microbatch where DP moves nothing, the stages are
FLOP-imbalanced, and the bubble wastes (S-1)/(M+S-1) of the schedule.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import Precision, WriteConfig
from ..kernels.embed_epilogue import embed_epilogue
from ..models import pipeline
from ..ops import dct
from .mesh import (_host_tensor, from_wire, rank_device, to_wire,
                   via_host)

STAGE_AXIS = "stage"
N_STAGES = 3


class StageMesh:
    """Ranks 0 .. n_stages - 1 of the default group as a 1-D stage axis.

    ``stage`` is this rank's stage, None on a rank beyond the stages.
    Activations move with ``isend``/``recv``, through pinned host copies
    where ``mesh.via_host`` says so, as ``mesh.Mesh``'s collectives do.
    """

    def __init__(self, n_stages: int, device: torch.device):
        self.n_stages = n_stages
        self.device = device
        self.group = dist.new_group(list(range(n_stages)))
        rank = dist.get_rank()
        self.stage: Optional[int] = rank if rank < n_stages else None
        self.via_host = via_host(device)

    def send(self, t: torch.Tensor, stage: int):
        """Start sending ``t`` to ``stage``: ``(work, buffer)``, the buffer
        to be kept until ``work.wait()``."""
        buf = to_wire(t, self.via_host)
        return dist.isend(buf, dst=stage, group=self.group), buf

    def recv(self, shape, dtype, stage: int) -> torch.Tensor:
        """Receive a ``shape``/``dtype`` tensor from ``stage``."""
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.via_host else self.device,
                          pin_memory=self.via_host)
        dist.recv(buf, src=stage, group=self.group)
        return from_wire(buf, self.device, self.via_host)


def make_stage_mesh(n_stages: int = N_STAGES, device="cuda") -> StageMesh:
    """A stage axis over the first ``n_stages`` ranks of the default group;
    every rank must call it."""
    world = dist.get_world_size()
    if world < n_stages:
        raise ValueError(f"need {n_stages} ranks, have {world}")
    return StageMesh(n_stages, rank_device(device))


def _stage1(t: torch.Tensor, marks: torch.Tensor, config: WriteConfig,
            h: int, w: int):
    """Half-transformed plane -> (delta, idx): second pass, rank, modulate,
    as ``pipeline._modulated`` computes them."""
    ax = dct.shorter_axis(h, w)
    idx, original = pipeline._rank_from_half(
        t, marks.shape[-1], config.ordering, config.custom_ordering, ax,
        config.rank_version)
    new_values = pipeline._modulate(idx, original, marks, config)
    return (new_values - original).to(torch.float32), idx


def embed_staged(images, marks, mesh: StageMesh,
                 config: WriteConfig = WriteConfig(
                     precision=Precision.DEFAULT)):
    """Pipeline-parallel embed of (M, B_mb, H, W, 3) u8 microbatches.

    ``images`` is the global host array, the same on every rank;
    ``marks``: (N,) or (MARKS, N), shared across images (per-image marks
    are a DP concern). Returns, on the last stage's rank, the (M, B_mb, H,
    W, 3) u8 result, bit-equal to ``pipeline.embed`` applied per
    microbatch; None on the other ranks.

    Requires a fast-tier precision (the stage bodies are the fast path's;
    the HIGHEST tier is the reference-exact single-device parity path and
    is not staged).
    """
    if config.precision is Precision.HIGHEST:
        raise ValueError("staged embed requires a fast-tier precision "
                         "(DEFAULT or HIGH)")
    if mesh.n_stages != N_STAGES:
        raise ValueError(f"the staged embed has {N_STAGES} stages, the mesh "
                         f"{mesh.n_stages}")
    sid = mesh.stage
    if sid is None:
        return None
    images = _host_tensor(images)
    marks = _host_tensor(marks).to(mesh.device)
    if marks.ndim == 1:
        marks = marks[None]
    m, bmb, h, w, _ = images.shape
    n = marks.shape[-1]
    last = mesh.n_stages - 1
    out = (torch.empty((m, bmb, h, w, 3), dtype=torch.uint8,
                       device=mesh.device) if sid == last else None)
    pending = []
    for tick in range(m + mesh.n_stages - 1):
        mb = tick - sid
        if not 0 <= mb < m:
            continue  # fill or drain: this stage idles this tick
        if sid == 0:
            rgb = images[mb].to(mesh.device)
            t = pipeline._half_pass(rgb, config.precision)
            pending.append(mesh.send(t.to(torch.bfloat16), 1))
        elif sid == 1:
            t = mesh.recv((bmb, h, w), torch.bfloat16, 0)
            delta, idx = _stage1(t, marks, config, h, w)
            pending += [mesh.send(delta, last), mesh.send(idx, last)]
        else:
            delta = mesh.recv((bmb, n), torch.float32, 1)
            idx = mesh.recv((bmb, n), torch.int64, 1)
            rgb = images[mb].to(mesh.device).contiguous()
            out[mb] = embed_epilogue(rgb, delta, idx)
    for work, _ in pending:
        work.wait()
    return out
