"""The external simulation's shared-memory ingest (``ingest/shm.py``)
and its debug and recovery CLI (``ingest/shm_tool.py``)."""

from scenery_insitu_tpu_torch.ingest.shm import (  # noqa: F401
    ShmConsumer, ShmProducer, ShmShardedVolumeSource, ShmVolumeSource,
    channel_stats, demo_producer, ensure_built, reset_readers, unlink)
