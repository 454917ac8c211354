"""Multi-GPU rendering over a (tile, spp) device mesh (counterpart of
``tpu_pt/dist.py``).

The reference's multi-GPU scaffolding, the 8 x 4 round-robin tile
assignment of ``StaticWorkDistribution`` (``sutil/WorkDistribution.h:34-90``)
and the P2P frame assembly of ``CUDAOutputBuffer``
(``sutil/CUDAOutputBuffer.h:45-51``), becomes row-tile sharding of the
frame over a ``tile`` mesh axis with samples also sharded over an ``spp``
axis and summed by ``all_reduce`` (BASELINE.json config 5).

The JAX package drives every device from one process (``shard_map`` over
a ``Mesh``); here each device is one ``torch.distributed`` rank, the mesh
is a ``DeviceMesh`` with dims ``("tile", "spp")`` laid out row-major
(``rank = tile * n_spp + spp``), and collectives run on its groups: NCCL
on the card, gloo only when the caller asks for the CPU. Collectives run
in a one-rank world too. The accumulation buffer stays a per-rank block
of rows on the rank's device across frames.

Because the RNG is counter-based, an (n_tile x n_spp)-sharded frame
draws the same (pixel, sample) set as the single-device frame: equal up
to the order of float adds, and bitwise for tile-only sharding on the
``scan`` scheduler.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import film
from .config import RenderConfig
from .profiling import span
from .render import (NUM_DONE_REASONS, CameraArrays, RenderStats,
                     render_wavefront)
from .scene.arrays import SceneArrays
from .whitted import render_whitted_wavefront

MESH_DIMS = ("tile", "spp")


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device="cuda") -> None:
    """Join a multi-process render job, one rank per device (the DCN seam,
    SURVEY §5.8). Idempotent.

    With ``coordinator_address`` ("host:port", the rank 0 process's) the
    world is ``num_processes`` ranks and this is rank ``process_id``;
    with no arguments ``torchrun``'s environment names them (``env://``).
    On the card (the default) the rank first takes its own device
    (``LOCAL_RANK``, else its rank modulo the host's devices) and joins
    over NCCL; ``device="cpu"`` joins over gloo. Nothing falls back: no
    card with ``device="cuda"`` raises."""
    if dist.is_initialized():
        return
    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: no CUDA device for NCCL "
                               "(device='cpu' joins a gloo world)")
        rank = (process_id if process_id is not None
                else int(os.environ["RANK"]))
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if coordinator_address is None:
        kw = dict(init_method="env://")
    else:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group("nccl" if on_card else "gloo", **kw)


def _device_type() -> str:
    """The device type of this world's ranks: NCCL ranks hold cards."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its card (``init_multihost`` set it), or the
    CPU in a gloo world. Scenes and cameras of the step go there."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_shape(n: int, n_tile: int | None = None,
               n_spp: int | None = None) -> tuple[int, int]:
    """(n_tile, n_spp) of a mesh over ``n`` ranks. Defaults: split samples
    2-way when ``n`` is even and above 1, tiles take the rest; a given
    factor fixes the other. Raises unless n_tile * n_spp == n."""
    if n_tile is None and n_spp is None:
        n_spp = 2 if n % 2 == 0 and n > 1 else 1
        n_tile = n // n_spp
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    if n_tile * n_spp != n:
        raise ValueError(f"a {n_tile} x {n_spp} mesh does not cover "
                         f"{n} ranks")
    return n_tile, n_spp


def device_mesh(n_tile: int | None = None,
                n_spp: int | None = None) -> DeviceMesh:
    """A (tile, spp) mesh over every rank of the world (defaults as
    :func:`mesh_shape`)."""
    return init_device_mesh(_device_type(),
                            mesh_shape(dist.get_world_size(), n_tile, n_spp),
                            mesh_dim_names=MESH_DIMS)


def multihost_mesh(n_spp: int = 1) -> DeviceMesh:
    """A (tile, spp) mesh whose ``spp`` groups never leave a host.

    Tiles are embarrassingly parallel (the only cross-tile traffic is the
    per-frame stats sum), so the tile axis may span hosts; the spp axis
    carries the per-pixel sum of sample means every frame, so each of its
    groups holds consecutive ranks of one host. ``n_spp`` must divide the
    ranks per host: ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it), else the
    host's cards, and a CPU world counts as one host."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if _device_type() == "cuda" else world)
    if local % n_spp:
        raise ValueError(f"n_spp {n_spp} does not divide the {local} ranks "
                         "of a host")
    return device_mesh(world // n_spp, n_spp)


def local_config(cfg: RenderConfig, n_tile: int,
                 n_spp: int) -> tuple[RenderConfig, int]:
    """One rank's share of ``cfg``: the config with its samples and the
    pixels of its rows. Raises unless the rows split into ``n_tile``
    tiles and the samples into ``n_spp`` shards."""
    if cfg.height % n_tile:
        raise ValueError(f"height {cfg.height} does not split into "
                         f"{n_tile} tiles")
    if cfg.spp % n_spp:
        raise ValueError(f"spp {cfg.spp} does not split into {n_spp} "
                         "shards")
    return (cfg.with_(spp=cfg.spp // n_spp),
            cfg.width * cfg.height // n_tile)


def make_sharded_renderer(scene, cfg: RenderConfig, mesh: DeviceMesh,
                          wavefront_fn=None):
    """A progressive frame step sharded over ``mesh``.

    Returns ``step(cam, frame_idx, accum) -> (accum, frame_u8, stats)``,
    where ``accum`` is this rank's block of rows, [H / n_tile, W, 3]
    (:func:`init_accum_sharded`), updated in place as ``render_frame``
    updates its accumulator, ``frame_u8`` is the block's sRGB image and
    ``stats`` the whole frame's counts (summed over the world).

    ``scene`` is a ``SceneArrays`` (path tracer) or a ``WhittedScene``
    (direct-lighting pipeline); the integrator follows the scene's type,
    as the reference's multi-GPU scaffold is pipeline-agnostic
    (``sutil/WorkDistribution.h:34-90``). ``wavefront_fn`` overrides it
    (``render.render_wavefront``'s signature)."""
    if wavefront_fn is None:
        wavefront_fn = (render_wavefront if isinstance(scene, SceneArrays)
                        else render_whitted_wavefront)
    n_tile, n_spp = mesh.shape
    cfg_local, pixels_per_tile = local_config(cfg, n_tile, n_spp)
    pixel_start = mesh.get_local_rank("tile") * pixels_per_tile
    sample_offset = mesh.get_local_rank("spp") * cfg_local.spp
    spp_group = mesh.get_group("spp")
    rows = cfg.height // n_tile

    def step(cam: CameraArrays, frame_idx: int, accum: torch.Tensor):
        with span("pt.frame"):
            # tpu_pt.dist._render_block: this rank's rows with its samples.
            rad, stats = wavefront_fn(scene, cam, cfg_local, pixel_start,
                                      pixels_per_tile, frame_idx,
                                      sample_offset=sample_offset)
            # Mean of per-shard means == global mean (equal shard sizes).
            dist.all_reduce(rad, group=spp_group)
            rad = rad / n_spp
            counts = torch.cat([stats.rays_traced.reshape(1),
                                stats.shadow_rays.reshape(1),
                                stats.done_histogram,
                                stats.wavefront_iterations.reshape(1)])
            dist.all_reduce(counts)
            stats = RenderStats(rays_traced=counts[0], shadow_rays=counts[1],
                                done_histogram=counts[2:2 + NUM_DONE_REASONS],
                                wavefront_iterations=counts[-1])
            frame = rad.reshape(rows, cfg.width, 3)
            accum.copy_(film.accumulate(accum, frame, frame_idx))
            return accum, film.make_color(accum), stats

    return step


def init_accum_sharded(cfg: RenderConfig, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's zeroed block of the accumulation buffer,
    [H / n_tile, W, 3] f32 on its device."""
    return torch.zeros((cfg.height // mesh.shape[0], cfg.width, 3),
                       dtype=torch.float32, device=rank_device(mesh))


def gather_frame(block: torch.Tensor, mesh: DeviceMesh) -> np.ndarray:
    """The whole frame on every rank as host numpy: the blocks of the
    ``tile`` group gathered in tile order (the cross-host analog of
    CUDAOutputBuffer's getHostPointer)."""
    parts = [torch.empty_like(block) for _ in range(mesh.shape[0])]
    dist.all_gather(parts, block.contiguous(), group=mesh.get_group("tile"))
    return torch.cat(parts).cpu().numpy()
