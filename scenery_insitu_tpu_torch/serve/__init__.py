"""The VDI edge-serving tier (docs/SERVING.md).

``python -m scenery_insitu_tpu_torch.serve`` runs the edge process (on
CUDA unless ``--device cpu``): `ViewerServer` subscribes to a composited
VDI stream and answers N concurrent client cameras per frame from one
batched render (`ops.vdi_novel.render_vdi_batch`) — sim + march + composite stay O(1)
while viewer cost scales on this separate, cacheable tier. `ViewerClient`
is the viewer endpoint (typed answers, heartbeats, viewer-side
reprojection between keyframes).
"""

from scenery_insitu_tpu_torch.serve.client import (ServeDrop, ViewerClient,
                                                   ViewerFrame)
from scenery_insitu_tpu_torch.serve.reproject import reproject_planar
from scenery_insitu_tpu_torch.serve.server import (TIERS, ViewerServer,
                                                   camera_from_message)

__all__ = ["ViewerServer", "ViewerClient", "ViewerFrame", "ServeDrop",
           "reproject_planar", "camera_from_message", "TIERS"]
