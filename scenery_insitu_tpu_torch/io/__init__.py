"""VDI artifacts, wire compression and the I_PCM H.264 writer."""
