"""The single-chip entry point: the twin of the reference's
``__graft_entry__.entry()``."""

from __future__ import annotations

import torch

from scenery_insitu_tpu_torch.device import resolve_device


def entry(device=None):
    """``(frame_step, (u, v, eye))``: one in-situ frame step of the
    flagship pipeline (Gray-Scott advance, slice-march VDI generation,
    composite) on a 64^3 grid with 5 sim steps a frame, built for the z
    march from +z (eye (0, 0.5, 3.2)), and its example arguments.
    ``device=None`` means CUDA."""
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    dev = resolve_device(device)
    grid = 64
    eye = torch.tensor([0.0, 0.5, 3.2], dtype=torch.float32, device=dev)
    frame_step = grayscott_vdi_frame_step(sim_steps=5, engine="mxu",
                                          grid_shape=(grid,) * 3,
                                          axis_sign=(2, -1), device=dev)
    st = gs.GrayScott.init((grid,) * 3, device=dev)
    return frame_step, (st.u, st.v, eye)
