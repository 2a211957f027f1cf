"""Novel-view rendering of slice-march VDIs as banded matmuls.

A slice-march VDI's generating camera is a virtual axis-aligned camera,
so the samples at its depth ratio ``s`` lie on one world plane ``w =
const`` (a slice plane of the march), and that plane carries a uniform
pixel grid: the intermediate grid scaled about the eye by ``s``. A VDI
slice at depth ratio s is then an image, decoded from the per-pixel slab
lists by a masked reduction over K (no gathers), and resampling it onto a
new camera's rays at the same plane is the separable bilinear product of
the forward march (``Wv @ plane @ Wu^T``).

- `render_vdi_mxu`: the same-regime plane sweep. The new camera marches
  the VDI's slice planes in its own front-to-back order (either sign),
  resamples each decoded plane and composites alpha-under, then the
  intermediate image is warped to the display camera. The opacity is
  re-corrected per pixel for the new ray's inter-plane path length.
- `vdi_to_rgba_volume`: the pre-shaded proxy, every slice plane decoded
  and resampled onto a regular world grid (``f32[4, D, H, W]``), which the
  slice march renders along any axis (`render_vdi_any`,
  `render_vdi_proxy`).
- `render_vdi_exact`: closed-form in-slab path lengths along each output
  ray, any regime, no resampling.
- `render_vdi_batch`: one VDI, a stack of cameras, on one of the three
  tiers.

The resampling products run in f32 (``torch.matmul``; TF32 stays off).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from scenery_insitu_tpu_torch.core.camera import Camera, pixel_rays
from scenery_insitu_tpu_torch.core.vdi import VDI, VDIMetadata
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.ops import slicer
from scenery_insitu_tpu_torch.ops.sampling import adjust_opacity
from scenery_insitu_tpu_torch.ops.slicer import (AxisCamera, AxisSpec,
                                                 _interp_matrix,
                                                 make_axis_camera,
                                                 resample_product,
                                                 resolve_matmul_dtype,
                                                 warp_to_camera)

# pixels of a row block of `render_vdi_exact` times its event count: the
# size of each of its ~50 per-event temporaries (~128 MiB in f32)
_EXACT_BLOCK_ELEMS = 1 << 25


def _uvw(spec: AxisSpec, u, v, w) -> torch.Tensor:
    """An (x, y, z) vector from its (u, v, w) components."""
    out = [None] * 3
    out[spec.u_axis], out[spec.v_axis], out[spec.axis] = u, v, w
    return torch.stack([torch.as_tensor(c, dtype=torch.float32)
                        .to(u.device) for c in out])


def axis_spec_from_meta(meta: VDIMetadata, chunk: int = 16,
                        matmul_dtype: str = "bf16") -> AxisSpec:
    """The static AxisSpec of a slice-march VDI from its metadata alone:
    the virtual camera's forward axis is a volume axis (view row 2 is
    -forward), and the grid is the window. ``matmul_dtype`` resolves as
    `slicer.make_spec` resolves it: bf16 only when the metadata lies on
    a CUDA device."""
    fwd = -meta.view[2, :3].detach().cpu().numpy()
    axis = int(np.argmax(np.abs(fwd)))
    sign = 1 if fwd[axis] >= 0 else -1
    wd = meta.window_dims.detach().cpu().numpy()
    on_card = meta.view.device.type == "cuda"
    return AxisSpec(axis=axis, sign=sign, ni=int(wd[0]), nj=int(wd[1]),
                    chunk=chunk,
                    matmul_dtype=resolve_matmul_dtype(matmul_dtype, on_card))


def axis_camera_from_meta(meta: VDIMetadata, spec: AxisSpec) -> AxisCamera:
    """The generating virtual axis camera of a slice-march VDI, rebuilt
    from its metadata (a stored or streamed VDI ships no AxisCamera). The
    slice pitch comes from ``meta.model``'s diagonal (the voxel -> world
    affine of the generating volume); ``w0`` is approximate when the eye
    sat inside the volume along the march axis (the camera clamps its
    plane distance to one voxel there, which the metadata does not
    keep)."""
    view, proj = meta.view, meta.projection
    dev = view.device
    rot = view[:3, :3]
    eye = -rot.T @ view[:3, 3]
    a, ua, va = spec.axis, spec.u_axis, spec.v_axis

    # standard frustum: proj[0,0] = 2n/(r-l), proj[0,2] = (r+l)/(r-l), ...
    zp = proj[2, 3] / (proj[2, 2] - 1.0)                   # = near
    rl = 2.0 * zp / proj[0, 0]                             # r - l
    tb = 2.0 * zp / proj[1, 1]                             # t - b
    rpl = proj[0, 2] * rl                                  # r + l
    tpb = proj[1, 2] * tb                                  # t + b

    ni, nj = spec.ni, spec.nj
    fwd = np.zeros(3, np.float32)
    fwd[a] = spec.sign
    up = np.zeros(3, np.float32)
    up[va] = 1.0
    right = np.cross(fwd, up)
    true_up = np.cross(right, fwd)
    right_u = float(right[ua])
    up_v = float(true_up[va])

    ndc_x = (torch.arange(ni, dtype=torch.float32, device=dev) + 0.5) \
        / ni * 2 - 1
    ndc_y = 1.0 - (torch.arange(nj, dtype=torch.float32, device=dev)
                   + 0.5) / nj * 2
    u_grid = eye[ua] + (ndc_x * rl + rpl) * 0.5 * right_u
    v_grid = eye[va] + (ndc_y * tb + tpb) * 0.5 * up_v

    # the pitch from the voxel -> world model; an identity model (metadata
    # without placement) falls back to nw, exact for cubic voxels
    legacy = torch.all(torch.abs(meta.model - torch.eye(4, device=dev))
                       < 1e-12)
    dw = torch.where(legacy, meta.nw, meta.model[a, a])
    w0 = eye[a] + float(spec.sign) * zp
    far = proj[2, 3] / (proj[2, 2] + 1.0)
    return AxisCamera(eye_uvw=torch.stack([eye[ua], eye[va], eye[a]]),
                      view=view, proj=proj, u_grid=u_grid, v_grid=v_grid,
                      zp=zp, w0=w0, dwm=float(spec.sign) * dw, far=far)


def decode_slice(vdi: VDI, t: torch.Tensor, dt_ref: torch.Tensor
                 ) -> torch.Tensor:
    """Decode the VDI at per-pixel depths ``t [C, Nj, Ni]`` into per-step
    source planes ``[C, 5, Nj, Ni]``: premultiplied step rgb (3), the step
    alpha for traversing ``dt_ref`` (1) and dt_ref itself (1), so that a
    consumer can re-correct the opacity for its own path length after
    resampling. A masked reduction over the K slabs, no gathers."""
    starts = vdi.depth[:, 0]                               # [K, Nj, Ni]
    ends = vdi.depth[:, 1]
    inside = (t[:, None] >= starts[None]) & (t[:, None] < ends[None])
    insf = inside.to(torch.float32)                        # [C, K, Nj, Ni]
    rgba = torch.einsum("ckji,kdji->cdji", insf, vdi.color)
    ext = ends - starts
    length = torch.einsum("ckji,kji->cji", insf,
                          torch.where(torch.isfinite(ext), ext, 0.0))
    a_slab = torch.clamp(rgba[:, 3], 0.0, 1.0 - 1e-6)
    frac = dt_ref / torch.clamp(length, min=1e-6)
    a_step = adjust_opacity(a_slab, torch.clamp(frac, max=1.0))
    a_step = torch.where(length > 0.0, a_step, 0.0)
    scale = a_step / torch.clamp(a_slab, min=1e-6)
    rgb_step = rgba[:, :3] * scale[:, None]
    return torch.cat([rgb_step, a_step[:, None], dt_ref[:, None]], dim=1)


def _default_slices(ni0: int) -> int:
    """The plane count when the generating volume's slice count is
    unknown: intermediate grids are ~1.25x the in-plane voxel count and
    volumes roughly cubic."""
    return max(16, int(round(ni0 / 1.25)))


def _content_aabb(vdi: VDI, axcam0: AxisCamera, s_count: int):
    """In-plane world extent of the marched frustum over the VDI's own
    depth range, shared by the plane sweep's new grid and the proxy's
    target grid. Returns (u_lo, u_hi, v_lo, v_hi, smax)."""
    eu0, ev0 = axcam0.eye_u, axcam0.eye_v
    length0 = axcam0.ray_lengths()
    ds0 = torch.abs(axcam0.dwm) / axcam0.zp
    ends = vdi.depth[:, 1]
    s_of_end = torch.where(torch.isfinite(ends), ends, 0.0) / length0[None]
    smax = torch.minimum(torch.clamp(torch.amax(s_of_end), min=1.0),
                         1.0 + ds0 * s_count)
    ug, vg = axcam0.u_grid, axcam0.v_grid
    u_vals = torch.stack([ug[0], ug[-1], eu0 + (ug[0] - eu0) * smax,
                          eu0 + (ug[-1] - eu0) * smax])
    v_vals = torch.stack([vg[0], vg[-1], ev0 + (vg[0] - ev0) * smax,
                          ev0 + (vg[-1] - ev0) * smax])
    return (torch.amin(u_vals), torch.amax(u_vals),
            torch.amin(v_vals), torch.amax(v_vals), smax)


def _resample_planes(vdi: VDI, axcam0: AxisCamera, s0: torch.Tensor,
                     dt_ref: torch.Tensor, pos_u: torch.Tensor,
                     pos_v: torch.Tensor, matmul_dtype: str = "f32"
                     ) -> torch.Tensor:
    """The per-plane step of both consumers: decode the VDI on its planes
    at depth ratios ``s0 [C]`` (step alpha for ``dt_ref``) and resample
    the decoded channels from each plane's uniform grid (the generating
    grid scaled about the eye by s0) onto the plane's sample positions
    ``pos_u [C, M]``, ``pos_v [C, N]`` (`slicer.resample_product` in
    ``matmul_dtype``). Returns ``[C, 5, N, M]`` (rgb, alpha, dt_ref)."""
    _, _, nj0, ni0 = vdi.color.shape
    length0 = axcam0.ray_lengths()
    t_at = s0[:, None, None] * length0[None]
    src = decode_slice(vdi, t_at, torch.broadcast_to(dt_ref, t_at.shape))

    eu0, ev0 = axcam0.eye_u, axcam0.eye_v
    du0 = axcam0.u_grid[1] - axcam0.u_grid[0]
    dv0 = axcam0.v_grid[1] - axcam0.v_grid[0]
    su_org = eu0 + (axcam0.u_grid[0] - eu0) * s0           # [C]
    sv_org = ev0 + (axcam0.v_grid[0] - ev0) * s0
    wu = _interp_matrix(pos_u, su_org, du0 * s0, ni0)      # [C, M, Ni0]
    wv = _interp_matrix(pos_v, sv_org, dv0 * s0, nj0)      # [C, N, Nj0]
    return resample_product(wv, src, wu, matmul_dtype)


def vdi_to_rgba_volume(vdi: VDI, axcam0: AxisCamera, spec0: AxisSpec,
                       num_slices: Optional[int] = None) -> Volume:
    """Expand a slice-march VDI into an axis-aligned pre-shaded RGBA proxy
    (``Volume`` with data ``f32[4, D, H, W]``, premultiplied, alpha
    encoded per ``nominal_step``): each slice plane is decoded and
    resampled from its uniform grid onto a regular world grid with the
    forward march's banded products. The slice march renders the proxy
    along any axis (`render_vdi_any`), where the same-axis plane sweep
    cannot order the planes. Resolution: the VDI's grid in-plane, the
    generating march's plane count in depth (``num_slices``, default
    `_default_slices`). Its bytes: ``16 * num_slices * Nj * Ni``."""
    _, _, nj0, ni0 = vdi.color.shape
    dev = vdi.color.device
    s_count = _default_slices(ni0) if num_slices is None else num_slices
    a = spec0.axis
    ew0 = axcam0.eye_w

    u_lo, u_hi, v_lo, v_hi, _ = _content_aabb(vdi, axcam0, s_count)
    nu_t, nv_t = ni0, nj0
    sp_u = (u_hi - u_lo) / nu_t
    sp_v = (v_hi - v_lo) / nv_t
    dw = torch.abs(axcam0.dwm)
    # ascending world target grids (a Volume's origin is its min corner)
    tu = u_lo + (torch.arange(nu_t, dtype=torch.float32, device=dev)
                 + 0.5) * sp_u
    tv = v_lo + (torch.arange(nv_t, dtype=torch.float32, device=dev)
                 + 0.5) * sp_v
    nominal = torch.minimum(torch.minimum(sp_u, sp_v), dw)

    c = spec0.chunk
    nchunks = -(-s_count // c)
    planes = []
    for ci in range(nchunks):
        q = ci * c + torch.arange(c, dtype=torch.float32, device=dev)
        wq = axcam0.w0 + q * axcam0.dwm                    # [C] plane w
        s0 = float(spec0.sign) * (wq - ew0) / axcam0.zp
        live = (q < s_count) & (s0 > spec0.s_floor)
        # dead planes are zeroed below; their arithmetic stays finite
        s0 = torch.where(live, s0, 1.0)
        plane = _resample_planes(
            vdi, axcam0, s0, nominal, tu.expand(c, nu_t),
            tv.expand(c, nv_t), spec0.matmul_dtype)[:, :4]  # drop dt
        planes.append(plane * live[:, None, None, None].to(torch.float32))
    stack = torch.cat(planes)[:s_count]                    # [S, 4, v, u]

    # march order ascends w only for sign > 0; a Volume ascends w
    if spec0.sign < 0:
        stack = torch.flip(stack, dims=(0,))
        w_min = axcam0.w0 + (s_count - 1) * axcam0.dwm
    else:
        w_min = axcam0.w0

    data = stack.movedim(1, 0)                             # [4, w, v, u]
    # (w, v, u) -> (z, y, x)
    if a == 1:                                             # w=y, v=z, u=x
        data = data.permute(0, 2, 1, 3)
    elif a == 0:                                           # w=x, v=z, u=y
        data = data.permute(0, 2, 3, 1)
    origin = _uvw(spec0, u_lo, v_lo, w_min - 0.5 * dw)
    spacing = _uvw(spec0, sp_u, sp_v, dw)
    return Volume(data.contiguous(), origin, spacing)


def render_vdi_any(vdi: VDI, axcam0: AxisCamera, spec0: AxisSpec,
                   cam: Camera, width: int, height: int,
                   num_slices: Optional[int] = None,
                   background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                   axis_sign: Optional[Tuple[int, int]] = None,
                   slicer_cfg=None, proxy: Optional[Volume] = None,
                   exact: bool = False) -> torch.Tensor:
    """Novel view from any camera -> f32[4, H, W] premultiplied: the
    plane sweep (`render_vdi_mxu`) in the VDI's own regime, the pre-shaded
    proxy's slice march along the camera's axis otherwise. ``proxy``: a
    prebuilt `vdi_to_rgba_volume` (it depends on the VDI alone, so a
    client rendering several views of one VDI builds it once).
    ``exact=True`` routes to `render_vdi_exact`."""
    if exact:
        return render_vdi_exact(vdi, axcam0, spec0, cam, width, height,
                                background=background)
    new_axis, new_sign = axis_sign or slicer.choose_axis(cam)
    if new_axis == spec0.axis:
        return render_vdi_mxu(vdi, axcam0, spec0, cam, width, height,
                              num_slices=num_slices, background=background,
                              axis_sign=(new_axis, new_sign))
    if proxy is None:
        proxy = vdi_to_rgba_volume(vdi, axcam0, spec0,
                                   num_slices=num_slices)
    from scenery_insitu_tpu_torch.config import SliceMarchConfig

    cfg = slicer_cfg or SliceMarchConfig(matmul_dtype=spec0.matmul_dtype)
    spec_new = slicer.make_spec(cam, tuple(proxy.data.shape[-3:]), cfg,
                                axis_sign=(new_axis, new_sign))
    return render_vdi_proxy(proxy, cam, width, height, spec_new,
                            background=background)


def render_vdi_proxy(proxy: Volume, cam: Camera, width: int, height: int,
                     spec_new: AxisSpec,
                     background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
                     ) -> torch.Tensor:
    """March a prebuilt `vdi_to_rgba_volume` proxy from one camera ->
    f32[4, H, W] premultiplied (the per-view half of the proxy path);
    ``spec_new`` is the proxy grid's spec for the camera's regime."""
    return slicer.raycast_mxu(proxy, None, cam, width, height, spec_new,
                              background=background).image


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """N cameras as one Camera whose every field has a leading [N] axis:
    the input of `render_vdi_batch`."""
    cams = list(cams)
    if not cams:
        raise ValueError("stack_cameras needs at least one camera")
    return Camera(*(torch.stack(xs) for xs in zip(*cams)))


def _camera_at(cams: Camera, i: int) -> Camera:
    return Camera(*(x[i] for x in cams))


def render_vdi_batch(vdi: Optional[VDI], axcam0: Optional[AxisCamera],
                     spec0: AxisSpec, cams: Camera, width: int, height: int,
                     *, tier: str = "proxy",
                     num_slices: Optional[int] = None,
                     axis_sign: Optional[Tuple[int, int]] = None,
                     proxy: Optional[Volume] = None,
                     spec_new: Optional[AxisSpec] = None, slicer_cfg=None,
                     background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
                     ) -> torch.Tensor:
    """N cameras (`stack_cameras`) against one VDI -> f32[N, 4, H, W].
    Each element is the single-camera renderer of its tier on that camera,
    so it equals the independent call bit for bit, whatever else shares
    the batch; what the batch shares is paid once.

    - ``"exact"``: `render_vdi_exact` per camera, any regime.
    - ``"sweep"``: `render_vdi_mxu` per camera; ``axis_sign`` (the
      batch's one regime) is required.
    - ``"proxy"``: `render_vdi_proxy` per camera over one
      `vdi_to_rgba_volume` (``proxy``, or built here once); the regime's
      spec from ``spec_new`` or ``axis_sign``. With ``proxy`` and
      ``spec_new`` given, ``vdi`` and ``axcam0`` may be None."""
    n = cams.eye.shape[0]
    if tier == "exact":
        return torch.stack([
            render_vdi_exact(vdi, axcam0, spec0, _camera_at(cams, i),
                             width, height, background=background)
            for i in range(n)])
    if tier == "sweep":
        if axis_sign is None:
            raise ValueError(
                "tier='sweep' needs the batch's shared axis_sign regime")
        return torch.stack([
            render_vdi_mxu(vdi, axcam0, spec0, _camera_at(cams, i), width,
                           height, num_slices=num_slices,
                           background=background, axis_sign=axis_sign)
            for i in range(n)])
    if tier != "proxy":
        raise ValueError(f"unknown tier {tier!r} "
                         "(expected 'exact', 'sweep' or 'proxy')")
    if proxy is None:
        if vdi is None or axcam0 is None:
            raise ValueError("tier='proxy' needs either a prebuilt proxy "
                             "or the (vdi, axcam0) pair to build one")
        proxy = vdi_to_rgba_volume(vdi, axcam0, spec0,
                                   num_slices=num_slices)
    if spec_new is None:
        if axis_sign is None:
            raise ValueError(
                "tier='proxy' needs spec_new or the batch's shared "
                "axis_sign regime to derive it")
        from scenery_insitu_tpu_torch.config import SliceMarchConfig

        cfg = slicer_cfg or SliceMarchConfig(matmul_dtype=spec0.matmul_dtype)
        spec_new = slicer.make_spec(_camera_at(cams, 0),
                                    tuple(proxy.data.shape[-3:]), cfg,
                                    axis_sign=axis_sign)
    return torch.stack([
        render_vdi_proxy(proxy, _camera_at(cams, i), width, height,
                         spec_new, background=background)
        for i in range(n)])


def render_vdi_exact(vdi: VDI, axcam0: AxisCamera, spec0: AxisSpec,
                     cam: Camera, width: int, height: int,
                     background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                     s_cap: Optional[float] = None, frac_cap: float = 16.0
                     ) -> torch.Tensor:
    """Exact novel view of a slice-march VDI, any regime -> f32[4, H, W]
    premultiplied: per-ray in-slab path lengths in closed form.

    Along a straight output ray the generating camera's pixel coordinates
    are projective-linear in the ray parameter t, so every crossing of a
    generating pixel cell's edge has a closed form, and the cells crossed
    form a monotone staircase of at most Ni0 + Nj0 + 2 boundaries. Between
    consecutive boundaries the pixel (its K slabs and its reference ray
    length) is constant and the VDI depth r(t) = s(t) * len0[pixel] is
    linear in t, so each slab's traversed length is an interval overlap.
    Within an interval the disjoint slabs compose alpha-under in
    traversal order (ascending or descending r); across intervals the
    sorted t gives front to back.

    Rows are processed in blocks whose ``rows * W * E`` (E = Ni0 + Nj0 +
    4 events a ray) stays under ``_EXACT_BLOCK_ELEMS``; every pixel is
    independent of the others, so the blocks change no number.
    ``s_cap`` bounds the depth-ratio range (default: the VDI's deepest
    finite slab end plus one slice); ``frac_cap`` caps the
    path/thickness ratio fed to the opacity law."""
    k, _, nj0, ni0 = vdi.color.shape
    dev = vdi.color.device
    eu0, ev0 = axcam0.eye_u, axcam0.eye_v
    len0 = axcam0.ray_lengths()                             # [Nj0, Ni0]

    # slabs sorted by start depth per pixel (the composition within an
    # interval relies on it)
    starts0 = vdi.depth[:, 0]
    order = torch.argsort(torch.where(torch.isfinite(starts0), starts0,
                                      torch.inf), dim=0, stable=True)
    starts = torch.take_along_dim(starts0, order, dim=0)
    ends = torch.take_along_dim(vdi.depth[:, 1], order, dim=0)
    colors = torch.take_along_dim(vdi.color, order[:, None], dim=0)
    flat = (starts.reshape(k, nj0 * ni0), ends.reshape(k, nj0 * ni0),
            colors.reshape(k, 4, nj0 * ni0), len0.reshape(nj0 * ni0))

    if s_cap is None:
        ends_all = vdi.depth[:, 1]
        s_cap = torch.clamp(torch.amax(torch.where(
            torch.isfinite(ends_all), ends_all, 0.0) / len0[None]),
            min=1.0) * 1.001 + torch.abs(axcam0.dwm) / axcam0.zp
    s_cap = torch.as_tensor(s_cap, dtype=torch.float32, device=dev)

    origin, dirs = pixel_rays(cam, width, height)           # [3], [3,H,W]
    e = ni0 + nj0 + 4
    rows = max(1, min(height, _EXACT_BLOCK_ELEMS // (width * e)))
    img = torch.cat([
        _exact_rows(flat, axcam0, spec0, origin, dirs[:, r0:r0 + rows],
                    s_cap, frac_cap, k, nj0, ni0)
        for r0 in range(0, height, rows)], dim=1)
    bg = torch.tensor(background, dtype=torch.float32,
                      device=dev).reshape(4, 1, 1)
    return img + (1.0 - img[3:4]) * bg


def _exact_rows(flat, axcam0: AxisCamera, spec0: AxisSpec,
                origin: torch.Tensor, dirs: torch.Tensor, s_cap, frac_cap,
                k: int, nj0: int, ni0: int) -> torch.Tensor:
    """`render_vdi_exact` on one block of rows (``dirs [3, h, W]``),
    background-free -> f32[4, h, W]."""
    flat_s, flat_e, flat_c, flat_len = flat
    a, ua, va = spec0.axis, spec0.u_axis, spec0.v_axis
    eu0, ev0, ew0 = axcam0.eye_u, axcam0.eye_v, axcam0.eye_w
    du0 = axcam0.u_grid[1] - axcam0.u_grid[0]
    dv0 = axcam0.v_grid[1] - axcam0.v_grid[0]
    o_u, o_v, o_w = origin[ua], origin[va], origin[a]
    d_u, d_v, d_w = dirs[ua], dirs[va], dirs[a]             # [h, W]

    sgn = float(spec0.sign)
    s_A = sgn * (o_w - ew0) / axcam0.zp                     # s(t) = A + B t
    s_B = sgn * d_w / axcam0.zp                             # [h, W]
    eps = 1e-12

    def edge_crossings(o_c, d_c, e0, grid0, dg, count):
        """t of each generating-grid cell-edge crossing (inf: none):
        solve (o_c + t d_c - e0) = (edge - e0) s(t)."""
        edges = grid0[0] + (torch.arange(count + 1, dtype=torch.float32,
                                         device=d_c.device) - 0.5) \
            * dg - e0                                       # [M]
        u_a = (o_c - e0)[..., None]
        den = d_c[..., None] - edges * s_B[..., None]
        small = torch.abs(den) < eps
        t = (edges * s_A[..., None] - u_a) / torch.where(small, eps, den)
        return torch.where(small, torch.inf, t)

    def s_crossing(s_val):
        """t where the depth ratio reaches s_val (inf for in-plane rays,
        s_B == 0)."""
        small = torch.abs(s_B) < eps
        t = (s_val - s_A) / torch.where(small, eps, s_B)
        return torch.where(small, torch.inf, t)[..., None]

    raw = torch.cat(
        [edge_crossings(o_u, d_u, eu0, axcam0.u_grid, du0, ni0),
         edge_crossings(o_v, d_v, ev0, axcam0.v_grid, dv0, nj0),
         s_crossing(torch.tensor(spec0.s_floor, device=d_w.device)),
         s_crossing(s_cap)], dim=-1)                        # [h, W, E-1]
    # the ray's largest real forward crossing (+ margin) is its sentinel:
    # invalid or backward events collapse onto it as zero-width intervals
    fwd = torch.isfinite(raw) & (raw >= 0.0)
    t_hi = torch.amax(torch.where(fwd, raw, 0.0), dim=-1,
                      keepdim=True) + 1.0                   # [h, W, 1]
    events = torch.minimum(torch.clamp(torch.where(fwd, raw, t_hi),
                                       min=0.0), t_hi)
    events = torch.cat([events, torch.zeros_like(events[..., :1])], dim=-1)
    events = torch.sort(events, dim=-1).values
    t_a = events[..., :-1]                                  # [h, W, E-1]
    t_b = events[..., 1:]
    t_mid = 0.5 * (t_a + t_b)

    # the cell of each interval (from its midpoint)
    s_mid = s_A[..., None] + s_B[..., None] * t_mid
    s_safe = torch.where(torch.abs(s_mid) < eps, eps, s_mid)
    u_ref = eu0 + (o_u[..., None] + t_mid * d_u[..., None] - eu0) / s_safe
    v_ref = ev0 + (o_v[..., None] + t_mid * d_v[..., None] - ev0) / s_safe
    fx = (u_ref - (axcam0.u_grid[0] - 0.5 * du0)) / du0
    fy = (v_ref - (axcam0.v_grid[0] - 0.5 * dv0)) / dv0
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    valid = ((ix >= 0) & (ix < ni0) & (iy >= 0) & (iy < nj0)
             & (s_mid > spec0.s_floor) & (s_mid < s_cap) & (t_b > t_a))
    lin = (torch.clamp(iy, 0, nj0 - 1).to(torch.int64) * ni0
           + torch.clamp(ix, 0, ni0 - 1))                   # [h, W, E-1]

    lp = flat_len[lin]
    r_a = (s_A[..., None] + s_B[..., None] * t_a) * lp
    r_b = (s_A[..., None] + s_B[..., None] * t_b) * lp
    dt_int = t_b - t_a
    dr = r_b - r_a
    flat_r = torch.abs(dr) < 1e-9                          # in-plane ray

    # every slab's exact overlap and both composition orders in one pass
    # over k: ascending r is asc += T c_k, T *= (1 - a_k); descending r
    # is R = R (1 - a_k) + c_k with k ascending, which gives
    # sum_k c_k prod_{j>k} (1 - a_j), the composite in descending order
    asc_rgb = torch.zeros(t_a.shape + (3,), dtype=torch.float32,
                          device=t_a.device)
    dsc_rgb = torch.zeros_like(asc_rgb)
    t_asc = torch.ones_like(t_a)
    inv = dt_int / torch.where(torch.abs(dr) < eps, eps, dr)
    for kk in range(k):
        sk = flat_s[kk][lin]
        ek = flat_e[kk][lin]
        ck = flat_c[kk][:, lin]                             # [4, h, W, E-1]
        thick = ek - sk
        live = torch.isfinite(sk) & torch.isfinite(ek) & (thick > 0.0)
        ts = t_a + (sk - r_a) * inv
        te = t_a + (ek - r_a) * inv
        lo = torch.minimum(ts, te)
        hi = torch.maximum(ts, te)
        ov = torch.clamp(torch.minimum(hi, t_b) - torch.maximum(lo, t_a),
                         min=0.0)
        ov_flat = dt_int * ((r_a >= sk) & (r_a < ek))
        length = torch.where(flat_r, ov_flat, ov)          # world units
        frac = length / torch.clamp(thick, min=1e-6)
        a_slab = torch.clamp(ck[3], 0.0, 1.0 - 1e-6)
        alpha = adjust_opacity(a_slab, torch.clamp(frac, 0.0, frac_cap))
        alpha = torch.where(live & valid, alpha, 0.0)
        prem = (ck[:3].movedim(0, -1)
                / torch.clamp(a_slab, min=1e-6)[..., None]
                * alpha[..., None])                         # premult c_k
        asc_rgb = asc_rgb + t_asc[..., None] * prem
        t_asc = t_asc * (1.0 - alpha)
        dsc_rgb = dsc_rgb * (1.0 - alpha)[..., None] + prem
    rgb_int = torch.where((dr >= 0)[..., None], asc_rgb, dsc_rgb)
    a_int = 1.0 - t_asc

    # front to back across the (t-sorted) intervals: the exclusive
    # transmittance along the event axis
    t_excl = torch.cumprod(1.0 - a_int, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_excl[..., :1]),
                        t_excl[..., :-1]], dim=-1)
    rgb = torch.sum(t_excl[..., None] * rgb_int, dim=-2)
    alpha = 1.0 - torch.prod(1.0 - a_int, dim=-1)
    return torch.cat([rgb.movedim(-1, 0), alpha[None]], dim=0)


def render_vdi_mxu(vdi: VDI, axcam0: AxisCamera, spec0: AxisSpec,
                   cam: Camera, width: int, height: int,
                   num_slices: Optional[int] = None,
                   spec_new: Optional[AxisSpec] = None,
                   background: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                   early_exit_alpha: float = 0.999,
                   axis_sign: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """Render a slice-march VDI from a new camera of its own regime ->
    f32[4, H, W] premultiplied: per slice plane a decode, two banded
    resampling products and an alpha-under fold, then the warp to the
    display camera. Raises across regimes.

    ``num_slices``: the planes to march (default `_default_slices`; pass
    the generating volume's extent along the march axis when known: too
    few planes cut the far content). ``spec_new``: the new camera's
    intermediate grid (default 1.75x the VDI's, rounded up to 8).
    ``axis_sign``: the new camera's regime (default
    `slicer.choose_axis`)."""
    _, _, nj0, ni0 = vdi.color.shape
    dev = vdi.color.device
    axis = spec0.axis
    new_axis, new_sign = axis_sign or slicer.choose_axis(cam)
    if new_axis != axis:
        raise ValueError(
            f"novel view marches axis {new_axis} but the VDI was generated "
            f"along axis {axis}; use ops.vdi_render.render_vdi for "
            "cross-regime views")
    if spec_new is None:
        # the new frustum covers the generating one's far-plane footprint,
        # larger than the near-plane one by the depth-ratio range, so the
        # grid gets proportionally more pixels
        rnd = lambda n: max(8, -(-int(n) // 8) * 8)
        spec_new = AxisSpec(axis=axis, sign=new_sign,
                            ni=rnd(ni0 * 1.75), nj=rnd(nj0 * 1.75),
                            chunk=spec0.chunk,
                            matmul_dtype=spec0.matmul_dtype)
    s_count = _default_slices(ni0) if num_slices is None else num_slices

    ew0 = axcam0.eye_w
    length0 = axcam0.ray_lengths()                         # [Nj0, Ni0]
    ds0 = torch.abs(axcam0.dwm) / axcam0.zp
    du0 = axcam0.u_grid[1] - axcam0.u_grid[0]
    dv0 = axcam0.v_grid[1] - axcam0.v_grid[0]
    same_dir = spec_new.sign == spec0.sign

    # the new camera over the content's world box: the generating
    # frustum's footprint over the VDI's own depth range
    u_lo, u_hi, v_lo, v_hi, smax = _content_aabb(vdi, axcam0, s_count)
    w_first = axcam0.w0
    w_far = ew0 + float(spec0.sign) * smax * axcam0.zp
    w_lo = torch.minimum(w_first, w_far)
    w_hi = torch.maximum(w_first, w_far)
    box_min = _uvw(spec0, u_lo, v_lo, w_lo)
    box_max = _uvw(spec0, u_hi, v_hi, w_hi)
    # the stand-in volume feeds make_axis_camera's spacing reads (slice
    # pitch, footprint margins, plane-distance floor): the generating
    # grid's pitches
    sp = _uvw(spec0, torch.abs(du0), torch.abs(dv0), torch.abs(axcam0.dwm))
    dummy = Volume(torch.zeros((2, 2, 2), dtype=torch.float32, device=dev),
                   box_min, sp)
    axcam_n = make_axis_camera(dummy, cam, spec_new, box_min=box_min,
                               box_max=box_max)

    eun, evn, ewn = axcam_n.eye_u, axcam_n.eye_v, axcam_n.eye_w
    length_n = axcam_n.ray_lengths()                       # [Njn, Nin]
    c = spec_new.chunk
    nchunks = -(-s_count // c)
    dt0 = ds0 * length0                                    # step length
    # the opacity re-correction: planes are |dwm| apart in w, so a new
    # ray crosses them every |dwm| length_n / zp_n
    dtn = torch.abs(axcam0.dwm) / axcam_n.zp * length_n

    acc = torch.zeros((4, spec_new.nj, spec_new.ni), dtype=torch.float32,
                      device=dev)
    for ci in range(nchunks):
        qn = ci * c + torch.arange(c, dtype=torch.float32, device=dev)
        live = qn < s_count
        q0 = qn if same_dir else (s_count - 1.0 - qn)      # generating idx
        wq = axcam0.w0 + q0 * axcam0.dwm                   # [C] plane w
        # the generating ladder's depth ratio (>= 1 on live planes)
        s0 = float(spec0.sign) * (wq - ew0) / axcam0.zp
        # the new camera's samples on the plane
        sn = float(spec_new.sign) * (wq - ewn) / axcam_n.zp
        pos_u = eun + (axcam_n.u_grid[None, :] - eun) * sn[:, None]
        pos_v = evn + (axcam_n.v_grid[None, :] - evn) * sn[:, None]
        front = sn > spec_new.s_floor                      # before the eye

        val = _resample_planes(vdi, axcam0, s0, dt0, pos_u, pos_v,
                               spec_new.matmul_dtype)
        rgb = val[:, :3]
        a_res = torch.clamp(val[:, 3], 0.0, 1.0 - 1e-6)
        ratio = dtn[None] / torch.clamp(val[:, 4], min=1e-6)
        a_new = adjust_opacity(a_res, torch.clamp(ratio, 0.0, 16.0))
        a_new = a_new * (live & front)[:, None, None].to(torch.float32)
        scale = a_new / torch.clamp(a_res, min=1e-6)
        rgb_new = rgb * scale[:, None]

        for i in range(c):
            pgate = (acc[3] < early_exit_alpha).to(torch.float32)
            srcp = torch.cat([rgb_new[i], a_new[i][None]]) * pgate[None]
            acc = acc + (1.0 - acc[3:4]) * srcp

    return warp_to_camera(acc, axcam_n, spec_new, cam, width, height,
                          background)
