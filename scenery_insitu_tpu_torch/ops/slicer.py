"""Slice-march volume rendering: the raycaster core of the frame.

Pick the volume axis most aligned with the view direction and build a
virtual axis-aligned camera with the same eye, whose near plane is the
nearest slice plane and whose off-axis frustum covers the volume's
footprint. Every virtual-camera ray passes through the eye, so its
crossing of slice ``w = z`` is a uniform scale-and-shift of the
intermediate pixel grid, and resampling one slice onto the whole ray
bundle is separable bilinear: two banded interpolation matrices applied
as ``Wv @ slice @ Wu^T`` (two batched f32 matmuls). The slices are shaded
by the transfer function, opacity-corrected for the per-ray inter-slice
path length, and fed chunk by chunk, front to back, to a supersegment
fold. The VDI lives on the virtual camera's grid and its metadata
carries the virtual projection and view.

Folds (``SliceMarchConfig.fold``, the reference's names):

- ``xla``: the sequential ``supersegments.push`` machine;
- ``seg``: the segmented-scan fold (``ops/seg_fold.py``);
- ``pallas``: the machine through kernel B7 (``ops/cuda_march.py``),
  with the temporal count riding the same kernel;
- ``pallas_seg``: the segmented fold through kernel K1
  (``ops/cuda_seg.py``), fed shaded rgba and per-slice depth ratios;
- ``pallas_fused``: shading moved into the fold, kernel B5
  (``ops/cuda_fused.py``), fed the raw value planes chunk by chunk;
- ``fused_stream``: the value planes of the whole march gathered into
  one ``f32[S, Nj, Ni]`` buffer, then one launch of kernel B6.

Every fold but ``xla`` and ``seg`` counts the histogram seed through
kernel K2 (``ops/cuda_march.py``). ``auto`` resolves to ``pallas_seg``
on CUDA and to ``xla`` on the CPU, as the reference resolves it on and
off the TPU. The chunk loop is a Python loop; chunk occupancy is copied
to the host once per march, and the kernel folds update their packed
state in place.

Tile waves (``CompositeConfig.schedule="waves"``): every virtual-camera
column is its own ray fan, so a march of a subset of columns is the
column slice of the full march. `wave_camera` slices the camera's u grid
to one wave's columns, and the generators take the frame's shared
``axcam``, ``volp`` (the permuted copy) and occupancy gate, so T waves
cost one permuted copy and one gate a frame, not T.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
from scenery_insitu_tpu_torch.core.camera import Camera, frustum, look_at
from scenery_insitu_tpu_torch.core.transfer import TransferFunction
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import cuda_fused as cf
from scenery_insitu_tpu_torch.ops import cuda_march as cm
from scenery_insitu_tpu_torch.ops import cuda_seg as cs
from scenery_insitu_tpu_torch.ops import seg_fold as sf
from scenery_insitu_tpu_torch.ops import supersegments as ss
from scenery_insitu_tpu_torch.ops.sampling import adjust_opacity, nominal_step

# xyz axis index -> data dim of Volume.data [z, y, x], counted from the end
_DATA_DIM = {0: -1, 1: -2, 2: -3}
# march axis -> (u axis, v axis), both xyz indices
_UV = {2: (0, 1), 1: (0, 2), 0: (1, 2)}

FOLDS = ("xla", "pallas", "seg", "pallas_seg", "pallas_fused",
         "fused_stream")
# the folds whose histogram seed counts through kernel K2
_K2_FOLDS = ("pallas", "pallas_seg", "pallas_fused", "fused_stream")


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Static parameters of a slice march."""

    axis: int                 # march axis, xyz index (0=x, 1=y, 2=z)
    sign: int                 # +1: march toward +axis; -1: toward -axis
    ni: int                   # intermediate image width (u direction)
    nj: int                   # intermediate image height (v direction)
    chunk: int = 16           # slices folded per chunk
    matmul_dtype: str = "f32"  # resampling matmul operand dtype
    s_floor: float = 1e-3     # min depth ratio: slices closer are dropped
    skip_empty: bool = True   # chunk-occupancy empty-space skipping
    fold: str = "xla"         # one of FOLDS
    render_dtype: str = "f32"  # storage dtype of the marched volume copy
    # in-plane occupancy tiles: 0 = whole-chunk skipping only; N > 0 also
    # gates output row blocks whose bilinear support lies in empty tiles
    vtiles: int = 0

    @property
    def u_axis(self) -> int:
        return _UV[self.axis][0]

    @property
    def v_axis(self) -> int:
        return _UV[self.axis][1]


def resolve_engine(engine: str) -> str:
    """A render-engine name ("auto" | "mxu" | "gather"); raises on
    anything else. "auto" is the slice march on every device: the
    reference resolves it to the gather engine off its TPU, while here
    the slice march is the engine whose kernels the card runs."""
    if engine == "auto":
        return "mxu"
    if engine not in ("mxu", "gather"):
        raise ValueError(f"unknown render engine {engine!r} "
                         "(expected 'auto', 'mxu' or 'gather')")
    return engine


def choose_axis(cam: Camera) -> Tuple[int, int]:
    """The volume axis most aligned with the view direction (host-side).
    Returns (axis, sign)."""
    d = (cam.target.detach().cpu().numpy().astype(np.float64)
         - cam.eye.detach().cpu().numpy().astype(np.float64))
    axis = int(np.argmax(np.abs(d)))
    return axis, (1 if d[axis] >= 0 else -1)


def make_spec(cam: Camera, vol_shape: Tuple[int, int, int],
              cfg: Optional[SliceMarchConfig] = None,
              axis_sign: Optional[Tuple[int, int]] = None,
              multiple_of: int = 1) -> AxisSpec:
    """Static spec for a camera and a volume shape ([D, H, W]).

    ``multiple_of`` rounds the intermediate dims up to a multiple of it:
    the distributed step splits the width into one column block per
    rank. The card is not a TPU, so the reference's off-TPU rules hold:
    ``matmul_dtype`` resolves to f32 (bf16 resampling is a later PR) and
    ``occupancy_vtiles=-1`` to 0. ``fold="auto"`` resolves by the
    camera's device: ``pallas_seg`` (kernels K1/K2) on CUDA, ``xla`` on
    the CPU."""
    cfg = cfg or SliceMarchConfig()
    axis, sign = axis_sign or choose_axis(cam)
    u_axis, v_axis = _UV[axis]
    dims_xyz = (vol_shape[2], vol_shape[1], vol_shape[0])
    step = int(8 * multiple_of // np.gcd(8, multiple_of))
    rnd = lambda n: max(step, int(-(-int(n * cfg.scale) // step)) * step)
    ni = rnd(dims_xyz[u_axis])
    nj = rnd(dims_xyz[v_axis])
    fold = cfg.fold
    if fold == "auto":
        fold = "pallas_seg" if cam.eye.device.type == "cuda" else "xla"
    if fold not in FOLDS:
        raise ValueError(f"unknown fold schedule {fold!r} (expected 'auto', "
                         "'xla', 'pallas', 'seg', 'pallas_seg', "
                         "'pallas_fused' or 'fused_stream')")
    vt = cfg.occupancy_vtiles
    if vt < 0:
        vt = 0
    if vt:
        vt = max(1, min(vt, dims_xyz[v_axis] // 2, nj // 2))
    return AxisSpec(axis=axis, sign=sign, ni=ni, nj=nj, chunk=cfg.chunk,
                    matmul_dtype="f32", s_floor=cfg.s_floor,
                    skip_empty=cfg.skip_empty, fold=fold, vtiles=vt,
                    render_dtype=cfg.render_dtype)


class AxisCamera(NamedTuple):
    """Per-frame state of the virtual axis-aligned camera (tensors)."""

    eye_uvw: torch.Tensor   # f32[3] eye in (u, v, w) component order
    view: torch.Tensor      # f32[4, 4]
    proj: torch.Tensor      # f32[4, 4] off-axis frustum projection
    u_grid: torch.Tensor    # f32[Ni] world u of intermediate columns
    v_grid: torch.Tensor    # f32[Nj] world v of intermediate rows
    zp: torch.Tensor        # f32[] eye -> reference-plane distance
    w0: torch.Tensor        # f32[] world w of marched slice 0
    dwm: torch.Tensor       # f32[] signed world w step per marched slice
    far: torch.Tensor       # f32[]

    @property
    def eye_u(self):
        return self.eye_uvw[0]

    @property
    def eye_v(self):
        return self.eye_uvw[1]

    @property
    def eye_w(self):
        return self.eye_uvw[2]

    def ray_lengths(self) -> torch.Tensor:
        """f32[Nj, Ni]: distance from the eye to each reference-plane grid
        point = the ray parameter t at depth ratio 1."""
        du = self.u_grid - self.eye_u
        dv = self.v_grid - self.eye_v
        return torch.sqrt(dv[:, None] ** 2 + du[None, :] ** 2 + self.zp ** 2)


def permute_volume(vol: Volume, spec: AxisSpec) -> torch.Tensor:
    """Volume data -> contiguous march layout ``[S, Nv, Nu]``, flipped so
    the marched slice index ascends front to back; bf16 when
    ``spec.render_dtype == "bf16"``."""
    data = vol.data
    if data.dim() != 3:
        raise NotImplementedError(
            "pre-shaded RGBA volumes are a later slice of the port "
            "(ROADMAP queue A6)")
    if spec.render_dtype == "bf16" and data.dtype == torch.float32:
        data = data.to(torch.bfloat16)
    volp = data.permute({2: (0, 1, 2), 1: (1, 0, 2),
                         0: (2, 0, 1)}[spec.axis])
    if spec.sign < 0:
        volp = torch.flip(volp, dims=(0,))
    return volp.contiguous()


def make_axis_camera(vol: Volume, cam: Camera, spec: AxisSpec,
                     box_min: Optional[torch.Tensor] = None,
                     box_max: Optional[torch.Tensor] = None) -> AxisCamera:
    """The virtual camera of this frame; its footprint is the volume's
    AABB, or ``box_min``/``box_max`` when given: the distributed step
    passes the global volume's box, so every rank marches the same slice
    ladder onto the same intermediate grid."""
    a, ua, va = spec.axis, spec.u_axis, spec.v_axis
    dev = vol.origin.device
    box_min = vol.world_min if box_min is None else box_min
    box_max = vol.world_max if box_max is None else box_max

    eye = cam.eye
    ew, eu, ev = eye[a], eye[ua], eye[va]
    dw = vol.spacing[a]
    w0 = box_min[a] + 0.5 * dw if spec.sign > 0 else box_max[a] - 0.5 * dw
    dwm = spec.sign * dw
    zp = torch.maximum(spec.sign * (w0 - ew), dw)          # eye may sit inside

    fwd = np.zeros(3, np.float32)
    fwd[a] = spec.sign
    up = np.zeros(3, np.float32)
    up[va] = 1.0
    right = np.cross(fwd, up)
    true_up = np.cross(right, fwd)
    right_u = float(right[ua])                             # exactly ±1
    up_v = float(true_up[va])
    t32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    fwd_t, right_t, true_up_t = t32(fwd), t32(right), t32(true_up)

    view = look_at(eye, eye + fwd_t, t32(up))

    # off-axis frustum covering the box footprint projected from the eye
    # onto the reference plane (corners closer than the plane clamp to it)
    bits = np.array([[b >> d & 1 for d in range(3)] for b in range(8)],
                    bool)
    corners = torch.where(torch.as_tensor(bits, device=dev),
                          box_max[None], box_min[None])     # [8, 3]
    rel = corners - eye[None]
    ze = rel @ fwd_t
    zec = torch.maximum(ze, zp)
    xs = (rel @ right_t) * zp / zec
    ys = (rel @ true_up_t) * zp / zec
    mu = vol.spacing[ua]
    mv = vol.spacing[va]
    l, r = torch.amin(xs) - mu, torch.amax(xs) + mu
    b, t = torch.amin(ys) - mv, torch.amax(ys) + mv
    r = torch.maximum(r, l + 1e-5)
    t = torch.maximum(t, b + 1e-5)
    far = torch.maximum(torch.amax(ze), zp * 1.001) + dw

    proj = frustum(l, r, b, t, zp, far)

    # column i center <-> ndc_x = 2(i+.5)/Ni - 1; row j <-> 1 - 2(j+.5)/Nj
    ndc_x = (torch.arange(spec.ni, dtype=torch.float32, device=dev)
             + 0.5) / spec.ni * 2 - 1
    ndc_y = 1.0 - (torch.arange(spec.nj, dtype=torch.float32, device=dev)
                   + 0.5) / spec.nj * 2
    u_grid = eu + (ndc_x * (r - l) + (r + l)) * 0.5 * right_u
    v_grid = ev + (ndc_y * (t - b) + (t + b)) * 0.5 * up_v

    return AxisCamera(eye_uvw=torch.stack([eu, ev, ew]), view=view,
                      proj=proj, u_grid=u_grid, v_grid=v_grid, zp=zp,
                      w0=w0, dwm=dwm, far=far)


# ------------------------------------------------------------- tile waves


def wave_block(ni: int, n_ranks: int, wave_tiles: int) -> int:
    """Column width of one tile wave's per-rank block: the intermediate
    width splits into ``n_ranks`` rank-owned blocks, each into
    ``wave_tiles`` tiles. Raises when the geometry does not divide."""
    if ni % (n_ranks * wave_tiles):
        raise ValueError(
            f"intermediate width {ni} not divisible by ranks*wave_tiles "
            f"= {n_ranks}*{wave_tiles} (pick wave_tiles so every rank's "
            f"{ni // n_ranks if n_ranks and ni % n_ranks == 0 else ni}"
            f"-column block splits evenly)")
    return ni // (n_ranks * wave_tiles)


def wave_cols(x: torch.Tensor, n_ranks: int, wave_tiles: int,
              w: int) -> torch.Tensor:
    """Tile wave ``w``'s columns of ``x [..., Ni]``: the w-th of
    ``wave_tiles`` sub-tiles of each of the ``n_ranks`` rank-owned
    blocks -> ``[..., n_ranks * wb]``."""
    ni = x.shape[-1]
    wb = wave_block(ni, n_ranks, wave_tiles)
    g = x.reshape(x.shape[:-1] + (n_ranks, wave_tiles, wb))
    return g[..., w, :].reshape(x.shape[:-1] + (n_ranks * wb,))


def wave_update_cols(x: torch.Tensor, xw: torch.Tensor, n_ranks: int,
                     wave_tiles: int, w: int) -> torch.Tensor:
    """Inverse of `wave_cols`: ``x`` with wave ``w``'s columns replaced
    by ``xw [..., n_ranks * wb]`` (a new tensor)."""
    ni = x.shape[-1]
    wb = wave_block(ni, n_ranks, wave_tiles)
    out = x.clone(memory_format=torch.contiguous_format)
    out.view(x.shape[:-1] + (n_ranks, wave_tiles, wb))[..., w, :] = \
        xw.reshape(xw.shape[:-1] + (n_ranks, wb))
    return out


def wave_camera(axcam: AxisCamera, spec: AxisSpec, n_ranks: int,
                wave_tiles: int, w: int) -> Tuple[AxisCamera, AxisSpec]:
    """The (AxisCamera, AxisSpec) of tile wave ``w``: the camera carries
    the wave's ``n_ranks * wb`` u-grid entries (one ``wb``-wide tile a
    rank-owned block, so the wave still splits into n rank blocks for
    the exchange) and the spec's ``ni`` shrinks to match. The march
    axis, chunking, fold and occupancy gating are u-independent and
    reused."""
    ug = wave_cols(axcam.u_grid, n_ranks, wave_tiles, w)
    return (axcam._replace(u_grid=ug),
            dataclasses.replace(spec, ni=ug.shape[-1]))


def slice_march_wave(vol: Volume, tf: TransferFunction, axcam: AxisCamera,
                     spec: AxisSpec, consume: Callable, carry0,
                     n_ranks: int, wave_tiles: int, w: int, **kwargs):
    """`slice_march` of tile wave ``w``'s columns only. Takes every
    `slice_march` keyword: pass the frame's shared ``volp`` and
    ``occupancy`` gate."""
    axcam_w, spec_w = wave_camera(axcam, spec, n_ranks, wave_tiles, w)
    return slice_march(vol, tf, axcam_w, spec_w, consume, carry0, **kwargs)


def _axis_params(vol: Volume, spec: AxisSpec):
    """(origin, spacing, count) of the u and v axes of this volume."""
    ua, va = spec.u_axis, spec.v_axis
    nu = vol.data.shape[_DATA_DIM[ua]]
    nv = vol.data.shape[_DATA_DIM[va]]
    return (vol.origin[ua], vol.spacing[ua], nu,
            vol.origin[va], vol.spacing[va], nv)


def _interp_matrix(pos: torch.Tensor, origin, spacing, n: int,
                   bounds=None) -> torch.Tensor:
    """Banded bilinear interpolation weights of world positions ``pos
    [C, M]`` against voxel rows 0..n-1 -> ``[C, M, n]``. Clamp-to-edge
    inside the volume extent, zero outside; ``bounds`` (lo, hi) further
    restricts to the half-open world interval a rank owns."""
    x = (pos - origin) / spacing - 0.5
    valid = (x >= -0.5) & (x <= n - 0.5)
    if bounds is not None:
        valid &= (pos >= bounds[0]) & (pos < bounds[1])
    xc = torch.clamp(x, 0.0, n - 1.0)
    cols = torch.arange(n, dtype=torch.float32,
                        device=pos.device).reshape(1, 1, n)
    w = torch.clamp(1.0 - torch.abs(xc[..., None] - cols), min=0.0)
    return w * valid[..., None].to(torch.float32)


def _pad_to_chunks(volp: torch.Tensor, c: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the march-layout volume along slices to a chunk multiple;
    returns (padded, nchunks). Shared by the march and the occupancy
    pass, so slab boundaries never disagree."""
    s_total = volp.shape[0]
    nchunks = -(-s_total // c)
    if nchunks * c != s_total:
        volp = torch.cat([volp, volp.new_zeros(
            (nchunks * c - s_total,) + tuple(volp.shape[1:]))], dim=0)
    return volp, nchunks


def chunk_occupancy(vol: Volume, tf: TransferFunction, spec: AxisSpec,
                    alpha_eps: float = 1e-5,
                    volp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[nchunks]: can the slab of ``spec.chunk`` slices contribute
    any opacity? The chunk level of the occupancy pyramid
    (``ops/occupancy.pyramid_from_volume``), conservative: resampling
    keeps values inside each slice's range, so a slab whose range maps
    to zero alpha everywhere is invisible."""
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    return _occ.pyramid_from_volume(vol, tf, dataclasses.replace(
        spec, vtiles=0), volp=volp, alpha_eps=alpha_eps).chunks


def chunk_occupancy_vtiles(vol: Volume, tf: TransferFunction,
                           spec: AxisSpec, alpha_eps: float = 1e-5,
                           volp: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bool[nchunks], bool[nchunks, vtiles]): the chunk and the (chunk
    x v-row band) levels of the occupancy pyramid in one pass, each band
    with its one-row apron; the tile count re-clamps against this
    volume's v extent (``ops/occupancy.resolved_tiles``)."""
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    pyr = _occ.pyramid_from_volume(vol, tf, spec, volp=volp,
                                   alpha_eps=alpha_eps)
    return pyr.chunks, pyr.tiles


def occupancy_for(vol: Volume, tf: TransferFunction, spec: AxisSpec,
                  volp: Optional[torch.Tensor] = None):
    """The occupancy structure `slice_march` consumes for ``spec``: None,
    bool[nchunks], or (chunks, tiles) when ``spec.vtiles > 0``."""
    if not spec.skip_empty:
        return None
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    return _occ.pyramid_from_volume(vol, tf, spec, volp=volp).gate(spec)


def _tile_hits(occ_tiles, axcam, spec, local_w0, s_total, nchunks, nv, ov,
               sv):
    """bool[nchunks, nb] on the host: does output row block b of chunk ci
    have bilinear support in an occupied (chunk, v-tile)? Computed for
    every chunk at once and copied to the host once per march."""
    c = spec.chunk
    nt = occ_tiles.shape[1]
    tv = nv // nt
    dev = occ_tiles.device
    ks = torch.arange(nchunks * c, dtype=torch.float32,
                      device=dev).reshape(nchunks, c)
    wk = local_w0 + ks * axcam.dwm
    sk = float(spec.sign) * (wk - axcam.eye_w) / axcam.zp
    live = (sk > spec.s_floor) & (ks < s_total)
    ev = axcam.eye_v
    pos_v = ev + (axcam.v_grid[None, None, :] - ev) * sk[..., None]
    xv = (pos_v - ov) / sv - 0.5                           # [n, C, Nj]
    tile_ids = torch.arange(nt, device=dev)
    big = float(2 * nv)
    bsz = spec.nj // nt
    hits = []
    for b in range(nt):
        b0 = b * bsz
        b1 = spec.nj if b == nt - 1 else b0 + bsz
        xb = xv[:, :, b0:b1]
        xlo = torch.amin(torch.where(live[..., None], xb, big), dim=(1, 2))
        xhi = torch.amax(torch.where(live[..., None], xb, -big), dim=(1, 2))
        r_lo = torch.clamp(torch.floor(xlo), 0, nv - 1)
        r_hi = torch.clamp(torch.floor(xhi) + 1.0, 0, nv - 1)
        t_lo = torch.clamp(torch.div(r_lo, tv, rounding_mode="floor"),
                           max=nt - 1).to(torch.int64)
        t_hi = torch.clamp(torch.div(r_hi, tv, rounding_mode="floor"),
                           max=nt - 1).to(torch.int64)
        hit = torch.any(occ_tiles & (tile_ids[None] >= t_lo[:, None])
                        & (tile_ids[None] <= t_hi[:, None]), dim=1)
        hits.append(hit & (xlo <= xhi))
    return torch.stack(hits, dim=1).cpu().numpy()


def slice_march(vol: Volume, tf: TransferFunction, axcam: AxisCamera,
                spec: AxisSpec, consume: Callable, carry0, occupancy=None,
                shaded_compact: bool = False,
                volp: Optional[torch.Tensor] = None, v_bounds=None,
                raw: bool = False, raw_full_skip: bool = False,
                w_bounds=None, step_scale: float = 1.0):
    """The chunked slice march. Calls ``consume(carry, rgba [C,4,Nj,Ni],
    t0 [C,Nj,Ni], t1 [C,Nj,Ni]) -> carry`` for each chunk of slices,
    front to back, and returns the final carry. rgba is premultiplied,
    opacity-corrected for the per-ray inter-slice path length, and zero
    outside the volume.

    ``occupancy`` (bool[nchunks], or (chunks, tiles) with in-plane
    tiles) skips the resampling and fold of provably empty chunks; a
    skipped chunk still feeds ONE all-empty sample (C=1) so the stream's
    gap semantics equal the full march's. The gate is copied to the host
    once per march.

    ``shaded_compact=True`` replaces the depth planes by the per-slice
    ratios: ``consume(carry, rgba, sk0 [C], sk1 [C])`` where the plane
    form's t0/t1 are ``sk0*length`` / ``sk1*length`` (length =
    ``axcam.ray_lengths()``) — the feed of kernel K1.

    ``raw=True`` feeds the resampled VALUE planes instead, unshaded:
    ``consume(carry, val [C,Nj,Ni], sk [C])`` with the value clipped to
    [0, 1] and ``-1`` where a sample is dead (outside the volume or
    ``v_bounds``, or a dropped slice), and the per-slice depth ratios —
    the feed of the fused kernels B5/B6, which shade themselves. A
    skipped chunk feeds one ``-1`` plane with its first slice's ratio;
    ``raw_full_skip=True`` feeds a whole chunk of ``-1`` planes with
    their ratios instead, so a consumer that gathers the whole stream
    receives C planes from every chunk. Both feeds leave B5's state the
    same (a dead plane only marks the previous sample empty); the one
    plane is kept for ``pallas_fused`` because B5 over a 16-plane dead
    chunk costs 0.0192 ms against 0.0088 ms for one plane at 640 x 640
    (``chip_smoke.py``'s ``fused_fold_chunk_dead_C*`` lines, the stream
    kept full, NVIDIA H100 80GB HBM3 at 700 W), ~0.04 ms a flagship
    frame.

    ``v_bounds`` (lo, hi): the half-open world interval of the in-plane
    v axis this volume owns; samples outside it are transparent. A rank
    of the distributed step whose slab is cut across v owns its rows
    only, so every sample belongs to exactly one rank.

    ``w_bounds`` (lo, hi): the open world interval of the march axis
    this volume owns; slices whose plane lies outside it are dead. A
    planned band or a brick padded past its own slices marches only
    those, as ``v_bounds`` owns in-plane rows (slice centres sit half a
    voxel inside a slice-aligned boundary, so the open test is exact).

    ``step_scale`` rescales the opacity correction's reference step
    (``nominal_step(vol, step_scale)``): a volume pooled 2^l-fold
    marches with ``step_scale = 2^-l`` so a coarse slice takes the
    opacity of the fine slices it replaces."""
    occ_tiles = None
    if isinstance(occupancy, tuple):
        occupancy, occ_tiles = occupancy
    volp0 = permute_volume(vol, spec) if volp is None else volp
    s_total = volp0.shape[0]
    c = spec.chunk
    volp, nchunks = _pad_to_chunks(volp0, c)
    if occupancy is not None and occupancy.shape[0] != nchunks:
        raise ValueError(
            f"occupancy describes {occupancy.shape[0]} chunks but this "
            f"march has {nchunks} (volume {tuple(vol.data.shape)}, "
            f"chunk {c})")

    ou, su, nu, ov, sv, nv = _axis_params(vol, spec)
    eu, ev, ew = axcam.eye_u, axcam.eye_v, axcam.eye_w
    dev = volp.device

    length = axcam.ray_lengths()                           # [Nj, Ni]
    ds = torch.abs(axcam.dwm) / axcam.zp                   # depth-ratio step
    ratio = ds * length / nominal_step(vol, step_scale)    # [Nj, Ni]

    a = spec.axis
    now_ = vol.data.shape[_DATA_DIM[a]]
    local_w0 = torch.where(axcam.dwm > 0,
                           vol.origin[a] + 0.5 * vol.spacing[a],
                           vol.origin[a] + (now_ - 0.5) * vol.spacing[a])

    occ_host = None if occupancy is None else \
        occupancy.detach().cpu().numpy()
    hits = None if occ_tiles is None else _tile_hits(
        occ_tiles, axcam, spec, local_w0, s_total, nchunks, nv, ov, sv)
    if raw:
        dead_rows = lambda rows: torch.full((c, rows, spec.ni), -1.0,
                                            device=dev)
    else:
        dead_rows = lambda rows: torch.zeros((c, 4, rows, spec.ni),
                                             device=dev)

    def rows_val(wv_r, slices, wu, keep_r, ratio_r):
        """Raw-mode block: resampled values ([C, B, Ni]) clipped to [0, 1]
        BEFORE the -1 sentinel is written where a sample is dead."""
        val = torch.bmm(torch.bmm(wv_r, slices), wu.transpose(1, 2))
        return torch.where(keep_r, torch.clamp(val, 0.0, 1.0), -1.0)

    def rows_rgba(wv_r, slices, wu, keep_r, ratio_r):
        """Resample + shade one block of output rows ([C, 4, B, Ni])."""
        val = torch.bmm(torch.bmm(wv_r, slices), wu.transpose(1, 2))
        val = torch.clamp(val, 0.0, 1.0)
        rgb, alpha = tf(val)                    # [C,B,Ni,3], [C,B,Ni]
        # outside-volume samples are transparent even where the transfer
        # function maps value 0 to nonzero alpha
        alpha = torch.where(keep_r, alpha, 0.0)
        alpha = adjust_opacity(alpha, ratio_r[None])
        return torch.cat([rgb.movedim(-1, 1) * alpha[:, None],
                          alpha[:, None]], dim=1)

    def work(carry, ci):
        ks = ci * c + torch.arange(c, dtype=torch.float32, device=dev)
        wk = local_w0 + ks * axcam.dwm
        sk = float(spec.sign) * (wk - ew) / axcam.zp       # depth ratios
        live = (sk > spec.s_floor) & (ks < s_total)
        if w_bounds is not None:
            live &= (wk > w_bounds[0]) & (wk < w_bounds[1])
        slices = volp[ci * c:(ci + 1) * c].to(torch.float32)

        pos_u = eu + (axcam.u_grid[None, :] - eu) * sk[:, None]   # [C, Ni]
        pos_v = ev + (axcam.v_grid[None, :] - ev) * sk[:, None]   # [C, Nj]
        wu = _interp_matrix(pos_u, ou, su, nu)                    # [C,Ni,Nu]
        wv = _interp_matrix(pos_v, ov, sv, nv, v_bounds)          # [C,Nj,Nv]
        inside = ((wv.sum(-1) > 0.0)[:, :, None]
                  & (wu.sum(-1) > 0.0)[:, None, :])
        keep = inside & live[:, None, None]

        rows_fn = rows_val if raw else rows_rgba
        if hits is None:
            rgba = rows_fn(wv, slices, wu, keep, ratio)
        else:
            nb = hits.shape[1]
            bsz = spec.nj // nb
            blocks = []
            for b in range(nb):
                b0 = b * bsz
                b1 = spec.nj if b == nb - 1 else b0 + bsz
                blocks.append(
                    rows_fn(wv[:, b0:b1], slices, wu, keep[:, b0:b1],
                            ratio[b0:b1]) if hits[ci, b]
                    else dead_rows(b1 - b0))
            rgba = torch.cat(blocks, dim=1 if raw else 2)

        if raw:
            return consume(carry, rgba, sk)
        if shaded_compact:
            return consume(carry, rgba, sk, sk + ds)
        t0 = sk[:, None, None] * length[None]
        t1 = (sk + ds)[:, None, None] * length[None]
        return consume(carry, rgba, t0, t1)

    def skip(carry, ci):
        # one explicit empty sample: closes any open supersegment exactly
        # like the stream of empties the full march would have produced
        s0 = float(spec.sign) * (local_w0 + float(ci * c) * axcam.dwm
                                 - ew) / axcam.zp
        if raw and raw_full_skip:
            sk_c = s0 + torch.arange(c, dtype=torch.float32, device=dev) * ds
            return consume(carry, torch.full((c, spec.nj, spec.ni), -1.0,
                                             device=dev), sk_c)
        if raw:
            return consume(carry, torch.full((1, spec.nj, spec.ni), -1.0,
                                             device=dev), s0[None])
        empty = torch.zeros((1, 4, spec.nj, spec.ni), device=dev)
        if shaded_compact:
            return consume(carry, empty, s0[None], s0[None] + ds)
        t = (s0 * length)[None]
        return consume(carry, empty, t, t)

    carry = carry0
    for ci in range(nchunks):
        if occ_host is None or occ_host[ci]:
            carry = work(carry, ci)
        else:
            carry = skip(carry, ci)
    return carry


# ------------------------------------------------------- plain-image render


def hittable_mask(vol: Volume, axcam: AxisCamera,
                  spec: AxisSpec) -> torch.Tensor:
    """bool[Nj, Ni]: can this intermediate-grid pixel's ray meet the
    volume's box at any marched depth? Per pixel, ``pos_u(s) = eu + (u_i
    - eu) * s`` lies in the volume's u extent for an interval of depth
    ratios s, likewise v; the pixel is hittable when the two intervals
    overlap somewhere in s > 0 between the volume's w faces
    (conservative). The grid's margin pixels never are."""
    a, ua, va = spec.axis, spec.u_axis, spec.v_axis
    big = 1e30

    def axis_interval(grid, e, lo, hi):
        d = grid - e
        safe = torch.where(d == 0, 1.0, d)
        inside = (e >= lo) & (e <= hi)
        s0 = torch.where(d > 0, (lo - e) / safe,
                         torch.where(d < 0, (hi - e) / safe,
                                     torch.where(inside, 0.0, big)))
        s1 = torch.where(d > 0, (hi - e) / safe,
                         torch.where(d < 0, (lo - e) / safe,
                                     torch.where(inside, big, -big)))
        return s0, s1

    u0, u1 = axis_interval(axcam.u_grid, axcam.eye_u, vol.world_min[ua],
                           vol.world_max[ua])
    v0, v1 = axis_interval(axcam.v_grid, axcam.eye_v, vol.world_min[va],
                           vol.world_max[va])
    sa = float(spec.sign) * (vol.world_min[a] - axcam.eye_w) / axcam.zp
    sb = float(spec.sign) * (vol.world_max[a] - axcam.eye_w) / axcam.zp
    lo = torch.maximum(torch.maximum(u0[None, :], v0[:, None]),
                       torch.minimum(sa, sb))
    hi = torch.minimum(torch.minimum(u1[None, :], v1[:, None]),
                       torch.maximum(sa, sb))
    return torch.clamp(lo, min=0.0) <= hi


def render_slices(vol: Volume, tf: TransferFunction, axcam: AxisCamera,
                  spec: AxisSpec, early_exit_alpha: float = 0.999,
                  v_bounds=None, step_scale: float = 1.0, occupancy=None,
                  volp: Optional[torch.Tensor] = None,
                  w_bounds=None):
    """The plain image on the intermediate grid: front-to-back
    alpha-under of the slice march, background-free premultiplied RGBA
    and the first-hit depth (ray parameter; +inf where empty), as a
    ``RaycastOutput``. Skips provably empty chunks (``occupancy``: see
    `_frame_march`; None builds the gate from ``volp``). A pixel stops
    accumulating once its alpha reaches ``early_exit_alpha``.
    ``v_bounds``, ``w_bounds``, ``step_scale``: see `slice_march` (the
    port's march has no u bounds: ranks own rows and slices, never
    columns).

    Each chunk composites in parallel over its slices: slice s
    contributes ``rgba_s * prod_{s' < s}(1 - alpha_s')``, and the
    per-pixel gate tests the alpha before the update, ``1 - (1 - A0) *
    Tl_excl(s)``, a prefix quantity; once a pixel crosses the gate every
    later sample is zeroed either way, so gating with the unmasked
    prefix is the sequential frozen-accumulator semantics up to the
    association of the products (a pixel within an ulp of the gate can
    round it one sample apart)."""
    from scenery_insitu_tpu_torch.ops.raycast import RaycastOutput

    def consume(carry, rgba, t0, t1):
        acc, first_t = carry
        t_run = torch.ones_like(acc[3])
        tls = []
        for i in range(rgba.shape[0]):
            tls.append(t_run)
            t_run = t_run * (1.0 - rgba[i, 3])
        tl = torch.stack(tls)                               # [C, Nj, Ni]
        a0 = acc[3:4]
        gate = 1.0 - (1.0 - a0) * tl < early_exit_alpha
        contrib = torch.sum(rgba * (tl * gate)[:, None], dim=0)
        acc = acc + (1.0 - a0) * contrib
        hit = gate & (rgba[:, 3] > 1e-4)
        t_hit = torch.amin(torch.where(hit, t0, torch.inf), dim=0)
        return acc, torch.minimum(first_t, t_hit)

    dev = vol.data.device
    acc0 = torch.zeros((4, spec.nj, spec.ni), dtype=torch.float32,
                       device=dev)
    t_0 = torch.full((spec.nj, spec.ni), torch.inf, device=dev)
    if volp is None:
        volp = permute_volume(vol, spec)
    occ = _resolve_occupancy(vol, tf, spec, occupancy, volp)
    acc, first_t = slice_march(vol, tf, axcam, spec, consume, (acc0, t_0),
                               occupancy=occ, volp=volp, v_bounds=v_bounds,
                               w_bounds=w_bounds, step_scale=step_scale)
    return RaycastOutput(acc, first_t)


def bilinear_image_sample(img: torch.Tensor, gy: torch.Tensor,
                          gx: torch.Tensor, fill: float = 0.0
                          ) -> torch.Tensor:
    """Sample ``img f32[ch, H, W]`` at continuous pixel coordinates (gy,
    gx) ``[...]`` (pixel centres at integers); out of range gives
    ``fill``."""
    ch, h, w = img.shape
    inb = (gx >= -0.5) & (gx <= w - 0.5) & (gy >= -0.5) & (gy <= h - 0.5)
    x = torch.clamp(gx, 0.0, w - 1.0)
    y = torch.clamp(gy, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
    fx, fy = x - x0, y - y0
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(ch, h * w)

    def at(yi, xi):
        return flat[:, yi * w + xi]

    out = (at(y0, x0) * ((1 - fx) * (1 - fy))[None]
           + at(y0, x1) * (fx * (1 - fy))[None]
           + at(y1, x0) * ((1 - fx) * fy)[None]
           + at(y1, x1) * (fx * fy)[None])
    return torch.where(inb[None], out, fill)


def warp_to_camera(image: torch.Tensor, axcam: AxisCamera, spec: AxisSpec,
                   cam: Camera, width: int, height: int,
                   background: Optional[Tuple[float, ...]] = (0.0, 0.0,
                                                              0.0, 0.0),
                   fill: float = 0.0, nearest: bool = False
                   ) -> torch.Tensor:
    """Resample an intermediate-grid image ``[ch, Nj, Ni]`` to the
    display camera's ``[ch, H, W]``: both cameras share the eye, so the
    map is the homography the reference plane induces, exact. Rays that
    miss the plane or leave the grid take ``fill``; ``background``
    (4-channel images) is blended under once, None leaves it out.
    ``nearest`` takes the nearest grid pixel instead of blending: a
    channel with sentinel values (a depth map's -1 for empty) must never
    blend a sentinel with a neighbour."""
    from scenery_insitu_tpu_torch.core.camera import pixel_rays

    _, dirs = pixel_rays(cam, width, height)               # [3, H, W]
    de = float(spec.sign) * dirs[spec.axis]
    hit = de > 1e-6
    tp = axcam.zp / torch.where(hit, de, 1.0)
    pu = axcam.eye_u + tp * dirs[spec.u_axis]
    pv = axcam.eye_v + tp * dirs[spec.v_axis]
    du = axcam.u_grid[1] - axcam.u_grid[0]
    dv = axcam.v_grid[1] - axcam.v_grid[0]
    gi = (pu - axcam.u_grid[0]) / du
    gj = (pv - axcam.v_grid[0]) / dv
    if nearest:
        gi, gj = torch.round(gi), torch.round(gj)
    out = bilinear_image_sample(image, gj, gi, fill)
    out = torch.where(hit[None], out, fill)
    if background is None:
        return out
    bg = torch.tensor(background, dtype=torch.float32,
                      device=out.device).reshape(-1, 1, 1)
    return out + (1.0 - out[3:4]) * bg


def raycast_mxu(vol: Volume, tf: TransferFunction, cam: Camera,
                width: int, height: int, spec: AxisSpec,
                early_exit_alpha: float = 0.999,
                background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                step_scale: float = 1.0):
    """The plain image on the slice march: `render_slices` on the
    intermediate grid, warped to the display camera
    (``RaycastOutput``, as ``ops.raycast.raycast`` returns it)."""
    from scenery_insitu_tpu_torch.ops.raycast import RaycastOutput

    axcam = make_axis_camera(vol, cam, spec)
    inter = render_slices(vol, tf, axcam, spec, early_exit_alpha,
                          step_scale=step_scale)
    img = warp_to_camera(inter.image, axcam, spec, cam, width, height,
                         background)
    # the depth: nearest-sample warp with -1 standing in for +inf, so an
    # empty pixel never blends with a valid neighbour
    depth = warp_to_camera(
        torch.where(torch.isfinite(inter.depth), inter.depth, -1.0)[None],
        axcam, spec, cam, width, height, background=None, fill=-1.0,
        nearest=True)[0]
    return RaycastOutput(img, torch.where(depth >= 0.0, depth, torch.inf))


# ----------------------------------------------------------- VDI generation


def _vdi_meta(vol: Volume, axcam: AxisCamera, ni: int,
              nj: int, step_scale: float = 1.0) -> VDIMetadata:
    """The VDI's metadata; ``volume_dims`` are ``vol``'s own (the
    distributed step puts the global volume's in their place)."""
    dev = vol.origin.device
    dims = torch.tensor(vol.dims_xyz, dtype=torch.float32, device=dev)
    model = torch.diag(torch.cat([vol.spacing, torch.ones(1, device=dev)]))
    model[:3, 3] = vol.origin
    return VDIMetadata.create(projection=axcam.proj, view=axcam.view,
                              model=model, volume_dims=dims,
                              window_dims=(ni, nj),
                              nw=nominal_step(vol, step_scale), index=0)


def _histogram_threshold(march, cfg: VDIConfig, k, nj: int, ni: int,
                         fold: str, device) -> torch.Tensor:
    """One counting march for all candidate thresholds at once (kernel
    K2 under the kernel folds, sequential ``push_count`` otherwise)."""
    tvec = ss.threshold_candidates(cfg.histogram_bins, cfg.thr_max,
                                   device=device)
    if fold in _K2_FOLDS:
        def consume_multi(carry, rgba, t0, t1):
            return cm.count_multi_chunk(carry, rgba, tvec)

        counts = march(consume_multi, cm.init_count_multi_packed(
            cfg.histogram_bins, nj, ni, device=device))[0]
    else:
        def consume_multi(st, rgba, t0, t1):
            for i in range(rgba.shape[0]):
                st = ss.push_count(st, tvec[:, None, None], rgba[i])
            return st

        counts = march(consume_multi, ss.init_count_multi(
            cfg.histogram_bins, nj, ni, device=device)).count
    return ss.pick_threshold(counts, tvec, k)


def _resolve_occupancy(vol: Volume, tf: TransferFunction, spec: AxisSpec,
                       occupancy, volp: torch.Tensor):
    """The gate a march consumes: built here from the permuted copy when
    ``occupancy`` is None, gated from a caller's
    ``ops/occupancy.OccupancyPyramid``, else a caller's gate as it is."""
    if occupancy is None:
        return occupancy_for(vol, tf, spec, volp=volp)
    from scenery_insitu_tpu_torch.ops import occupancy as _occ

    if isinstance(occupancy, _occ.OccupancyPyramid):
        return occupancy.gate(spec)
    return occupancy


def _frame_march(vol: Volume, tf: TransferFunction, cam: Camera,
                 spec: AxisSpec, box_min=None, box_max=None, v_bounds=None,
                 occupancy=None, axcam: Optional[AxisCamera] = None,
                 volp: Optional[torch.Tensor] = None, w_bounds=None,
                 step_scale: float = 1.0):
    """The frame's virtual camera and its march over one permuted copy
    and one occupancy gate: returns (axcam, march) with ``march(consume,
    carry0, **options)`` a `slice_march` of this frame (options:
    ``shaded_compact``, ``raw``, ``raw_full_skip``).
    ``box_min``/``box_max``: see `make_axis_camera`; ``v_bounds``: see
    `slice_march`. ``occupancy``: a caller's
    ``ops/occupancy.OccupancyPyramid`` for this volume and spec (built
    once a frame, for example from the sim's field ranges), whose gate
    replaces the pyramid built here from the permuted copy, or a gate
    it already took (`occupancy_for`). ``axcam`` and ``volp``: a
    caller's virtual camera (a tile wave's, `wave_camera`) and permuted
    copy, shared by the waves of a frame. ``w_bounds`` and
    ``step_scale``: see `slice_march`."""
    if axcam is None:
        axcam = make_axis_camera(vol, cam, spec, box_min, box_max)
    if volp is None:
        volp = permute_volume(vol, spec)
    occ = _resolve_occupancy(vol, tf, spec, occupancy, volp)

    def march(consume, carry0, **options):
        return slice_march(vol, tf, axcam, spec, consume, carry0,
                           occupancy=occ, volp=volp, v_bounds=v_bounds,
                           w_bounds=w_bounds, step_scale=step_scale,
                           **options)

    return axcam, march


def _fused_march(march, vol, tf, axcam, spec, threshold, k,
                 step_scale: float = 1.0):
    """The write march of the fused folds: the raw value planes, shaded
    and folded by kernel B5 chunk by chunk (``pallas_fused``), or
    gathered into one ``f32[S_pad, Nj, Ni]`` buffer, skipped chunks as
    ``-1`` planes, and folded by one launch of kernel B6
    (``fused_stream``: ~839 MB of buffer at 512 slices of 640 x 640).
    Returns the fold state."""
    nj, ni, c = spec.nj, spec.ni, spec.chunk
    dev = vol.data.device
    length = axcam.ray_lengths()
    ds = torch.abs(axcam.dwm) / axcam.zp
    ratio = ds * length / nominal_step(vol, step_scale)
    packed = cs.init_seg_packed(k, nj, ni, device=dev)
    knots = cf.tf_knots(tf)             # once a march, not once a launch
    if spec.fold == "pallas_fused":
        def consume(packed, val, sk):
            return cf.fused_fold_chunk(packed, val, length, ratio, sk,
                                       sk + ds, threshold, max_k=k, tf=tf,
                                       knots=knots)

        packed = march(consume, packed, raw=True)
    else:
        s_total = vol.data.shape[_DATA_DIM[spec.axis]]
        s_pad = -(-s_total // c) * c
        buf = torch.empty((s_pad, nj, ni), device=dev)
        skb = torch.empty((s_pad,), device=dev)

        def consume(i, val, sk):
            buf[i * c:(i + 1) * c] = val
            skb[i * c:(i + 1) * c] = sk
            return i + 1

        march(consume, 0, raw=True, raw_full_skip=True)
        cf.fused_stream_fold(packed, buf, length, ratio, skb, skb + ds,
                             threshold, max_k=k, chunk=c, tf=tf, knots=knots)
    return cs.unpack_seg_state(packed)


def _write_march(march, vol, tf, axcam, spec, threshold, k, count: bool,
                 step_scale: float = 1.0):
    """The write march of ``spec.fold``. Returns (color, depth, count)
    where count is the true per-pixel start count (``count=True``) or
    None. ``step_scale``: the march's (see `slice_march`), which the
    fused folds' own opacity correction takes too."""
    nj, ni = spec.nj, spec.ni
    device = vol.data.device
    if spec.fold in ("pallas_fused", "fused_stream"):
        state = _fused_march(march, vol, tf, axcam, spec, threshold, k,
                             step_scale)
        color, depth = sf.seg_finalize(state)
        return color, depth, state.cnt
    if spec.fold == "pallas_seg":
        length = axcam.ray_lengths()

        def consume(packed, rgba, sk0, sk1):
            return cs.fold_chunk_packed(packed, rgba, threshold, max_k=k,
                                        sk0=sk0, sk1=sk1, length=length)

        packed = march(consume, cs.init_seg_packed(k, nj, ni, device=device),
                       shaded_compact=True)
        state = cs.unpack_seg_state(packed)
        color, depth = sf.seg_finalize(state)
        return color, depth, state.cnt
    if spec.fold == "pallas":
        cnt = torch.zeros((nj, ni), dtype=torch.int32,
                          device=device) if count else None

        def consume(packed, rgba, t0, t1):
            cm.fold_chunk(packed, rgba, t0, t1, threshold, max_k=k,
                          count=cnt)
            return packed

        packed = march(consume, cm.init_packed(k, nj, ni, device=device))
        color, depth = ss.finalize(cm.unpack_state(packed))
        return color, depth, cnt
    if spec.fold == "seg":
        def consume(st, rgba, t0, t1):
            return sf.seg_fold_chunk(st, rgba, t0, t1, threshold, max_k=k)

        state = march(consume, sf.init_seg_state(k, nj, ni, device=device))
        color, depth = sf.seg_finalize(state)
        return color, depth, state.cnt

    def consume(carry, rgba, t0, t1):
        st, cst = carry
        for i in range(rgba.shape[0]):
            st = ss.push(st, k, threshold, rgba[i], t0[i], t1[i])
            if cst is not None:
                cst = ss.push_count(cst, threshold, rgba[i])
        return st, cst

    state, cstate = march(consume, (
        ss.init_state(k, nj, ni, device=device),
        ss.init_count(nj, ni, device=device) if count else None))
    color, depth = ss.finalize(state)
    return color, depth, None if cstate is None else cstate.count


def generate_vdi_mxu(vol: Volume, tf: TransferFunction, cam: Camera,
                     spec: AxisSpec, cfg: Optional[VDIConfig] = None,
                     box_min: Optional[torch.Tensor] = None,
                     box_max: Optional[torch.Tensor] = None, v_bounds=None,
                     occupancy=None, axcam: Optional[AxisCamera] = None,
                     volp: Optional[torch.Tensor] = None, w_bounds=None,
                     step_scale: float = 1.0, k_target=None
                     ) -> Tuple[VDI, VDIMetadata, AxisCamera]:
    """VDI generation on the slice march, with the threshold of
    ``cfg.adaptive_mode`` "histogram" (one counting march over all
    candidates), "search" (``adaptive_iters`` counting marches) or fixed
    (``adaptive=False``). ``adaptive_mode="temporal"`` carries state:
    use `generate_vdi_mxu_temporal`. ``box_min``/``box_max``/``v_bounds``
    are a distributed rank's: see `make_axis_camera` and
    `slice_march`; ``occupancy``, ``axcam`` and ``volp``: see
    `_frame_march` (a caller's ``axcam`` replaces the box); ``w_bounds``
    and ``step_scale`` (a brick pooled 2^l-fold marches with
    ``step_scale = 2^-l`` on the fine camera with ``dwm * 2^l``): see
    `slice_march`. ``k_target`` (an f32 0-dim tensor, the occupancy K
    budget's ``ops/occupancy.k_budget_target``) is the segment count the
    adaptive threshold picks against instead of K; output shapes stay
    at K."""
    cfg = cfg or VDIConfig()
    k = cfg.max_supersegments
    kt = k if k_target is None else k_target
    nj, ni = spec.nj, spec.ni
    dev = vol.data.device
    if cfg.adaptive and cfg.adaptive_mode == "temporal":
        raise ValueError(
            "adaptive_mode='temporal' carries per-frame threshold state — "
            "call generate_vdi_mxu_temporal(..., threshold=...) instead "
            "(seed the state with initial_threshold())")
    axcam, march = _frame_march(vol, tf, cam, spec, box_min, box_max,
                                v_bounds, occupancy, axcam, volp, w_bounds,
                                step_scale)
    if cfg.adaptive and cfg.adaptive_mode == "histogram":
        threshold = _histogram_threshold(march, cfg, kt, nj, ni, spec.fold,
                                         dev)
    elif cfg.adaptive:
        def count_fn(thr):
            def consume(st, rgba, t0, t1):
                for i in range(rgba.shape[0]):
                    st = ss.push_count(st, thr, rgba[i])
                return st
            return march(consume, ss.init_count(nj, ni, device=dev)).count
        threshold = ss.adaptive_threshold(count_fn, kt, cfg.adaptive_iters,
                                          nj, ni, device=dev)
    else:
        threshold = torch.full((nj, ni), cfg.threshold, device=dev)

    color, depth, _ = _write_march(march, vol, tf, axcam, spec, threshold,
                                   k, count=False, step_scale=step_scale)
    return (VDI(color, depth), _vdi_meta(vol, axcam, ni, nj, step_scale),
            axcam)


def initial_threshold(vol: Volume, tf: TransferFunction, cam: Camera,
                      spec: AxisSpec, cfg: Optional[VDIConfig] = None,
                      box_min: Optional[torch.Tensor] = None,
                      box_max: Optional[torch.Tensor] = None, v_bounds=None,
                      occupancy=None, axcam: Optional[AxisCamera] = None,
                      volp: Optional[torch.Tensor] = None, w_bounds=None,
                      step_scale: float = 1.0) -> ss.ThresholdState:
    """Seed state of the temporal threshold controller ([nj, ni] maps):
    one histogram counting march on the current scene. The other
    arguments: see `generate_vdi_mxu`."""
    cfg = cfg or VDIConfig()
    _, march = _frame_march(vol, tf, cam, spec, box_min, box_max, v_bounds,
                            occupancy, axcam, volp, w_bounds, step_scale)
    thr = _histogram_threshold(march, cfg, cfg.max_supersegments, spec.nj,
                               spec.ni, spec.fold, vol.data.device)
    return ss.init_threshold_state(thr, cfg.thr_min, cfg.thr_max)


def generate_vdi_mxu_temporal(vol: Volume, tf: TransferFunction,
                              cam: Camera, spec: AxisSpec,
                              threshold: ss.ThresholdState,
                              cfg: Optional[VDIConfig] = None,
                              box_min: Optional[torch.Tensor] = None,
                              box_max: Optional[torch.Tensor] = None,
                              v_bounds=None, occupancy=None,
                              axcam: Optional[AxisCamera] = None,
                              volp: Optional[torch.Tensor] = None,
                              w_bounds=None, step_scale: float = 1.0,
                              k_target=None,
                              ) -> Tuple[VDI, VDIMetadata, AxisCamera,
                                         ss.ThresholdState]:
    """VDI generation with ONE march per frame (adaptive_mode
    "temporal"). ``threshold`` is the carried controller state (seed it
    with `initial_threshold`); the write march yields the true per-pixel
    segment count, and ``update_threshold`` bisects the map toward the
    target band for the next frame. Returns (vdi, meta, axcam,
    next_threshold). ``box_min``/``box_max``/``v_bounds``/``occupancy``/
    ``axcam``/``volp``/``w_bounds``/``step_scale``: see
    `generate_vdi_mxu`; the controller bisects toward ``k_target``
    instead of K when it is given."""
    cfg = cfg or VDIConfig()
    k = cfg.max_supersegments
    axcam, march = _frame_march(vol, tf, cam, spec, box_min, box_max,
                                v_bounds, occupancy, axcam, volp, w_bounds,
                                step_scale)
    color, depth, count = _write_march(march, vol, tf, axcam, spec,
                                       threshold.thr, k, count=True,
                                       step_scale=step_scale)
    next_thr = ss.update_threshold(threshold, count,
                                   k if k_target is None else k_target,
                                   cfg.adaptive_delta, cfg.thr_min,
                                   cfg.thr_max, cfg.temporal_track)
    return (VDI(color, depth),
            _vdi_meta(vol, axcam, spec.ni, spec.nj, step_scale), axcam,
            next_thr)
