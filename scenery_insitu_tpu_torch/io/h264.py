"""Self-contained H.264/AVC Annex-B bitstream writer (I_PCM mode) — the
real-H264 closure of the reference's video boundary
(DistributedVolumeRenderer.kt:275-291 streams H264/UDP; this image ships
no libx264/openh264/ffmpeg, so runtime probing falls back to mp4v for
cv2 sinks — README "Known gaps").

Every H.264 decoder must support the I_PCM macroblock mode (raw
uncompressed samples inside a standard slice), and an all-I_PCM stream
needs NONE of the codec's prediction/transform/entropy machinery: just
Exp-Golomb-coded SPS/PPS/slice headers, byte-aligned raw macroblocks,
and start-code emulation prevention. This module writes exactly that —
a conformant Baseline-profile elementary stream any player can decode,
losslessly carrying the (studio-range) YUV 4:2:0 frames. The price is
bitrate (~1.5 B/px — it is PCM), so this is the compatibility/archival
codec: cv2's mp4v/MJPEG sinks remain the compressed transport when
present, and a real libx264 upgrade drops in by replacing the writer.
Numpy only. A copy of the reference's ``io/h264.py``; the sink also
takes the session's CPU tensors (``ipcm_stream_bytes`` gives a stream's
exact size).

Structure notes (ITU-T H.264 §7.3, Baseline):
- NAL: [start code] [1-byte header] [RBSP with 0x03 emulation bytes].
- SPS: profile 66, poc_type 2, frame_mbs_only; frame cropping trims the
  16-pixel macroblock padding back to the exact frame size.
- Every frame is an IDR with alternating idr_pic_id (consecutive IDRs
  must differ) — the stream is pure intra, seekable anywhere.
- I_PCM macroblock: mb_type ue(25), align to byte, then 256 luma +
  64 Cb + 64 Cr raw samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    """A host numpy array of an array or a (CPU) tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def ipcm_stream_bytes(width: int, height: int, frames: int,
                      fps: float = 30.0) -> int:
    """The exact size of an `h264_sink` stream of ``frames`` frames of
    ``width x height`` (even, as the sink crops them), from the I_PCM
    layout: the SPS and PPS, then per frame a start code and NAL header
    (5 bytes), the slice header with the first macroblock's ``mb_type``
    (17 or 19 bits and 9, padded to 4 bytes), every further
    ``mb_type`` padded to 2 bytes, 384 sample bytes a macroblock and the
    trailing byte. Studio-range samples hold no zero byte, so no
    emulation byte is ever inserted."""
    w = H264IPCMWriter(width, height, fps=fps)
    mbs = w.mb_w * w.mb_h
    return len(w.headers()) + frames * (5 + 4 + 386 * mbs - 2 + 1)


class BitWriter:
    """MSB-first bit packer for the (tiny) header parts of the stream."""

    def __init__(self):
        self.bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def u(self, value: int, bits: int) -> "BitWriter":
        for i in range(bits - 1, -1, -1):
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self.bytes.append(self._acc)
                self._acc = 0
                self._nbits = 0
        return self

    def ue(self, value: int) -> "BitWriter":
        """Unsigned Exp-Golomb."""
        v = value + 1
        nbits = v.bit_length()
        return self.u(v, 2 * nbits - 1)

    def se(self, value: int) -> "BitWriter":
        """Signed Exp-Golomb (0, 1, -1, 2, -2, ... -> 0, 1, 2, 3, 4)."""
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> "BitWriter":
        while self._nbits:
            self.u(0, 1)
        return self

    def raw(self, data: bytes) -> "BitWriter":
        assert self._nbits == 0, "raw bytes must be byte-aligned"
        self.bytes.extend(data)
        return self

    def rbsp_trailing(self) -> "BitWriter":
        self.u(1, 1)
        return self.align_zero()

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unterminated bitstring"
        return bytes(self.bytes)


def _emulation_prevent(rbsp: bytes) -> bytes:
    """Insert 0x03 after every 0x00 0x00 that precedes a byte <= 0x03
    (H.264 §7.4.1.1). Iterative scan — violations are rare in
    studio-range PCM (no 0x00 sample bytes), so each pass is cheap."""
    data = np.frombuffer(rbsp, np.uint8)
    out = []
    start = 0
    i = 0
    n = len(data)
    while i + 2 < n + 1:
        # vectorized jump to the next 00 00 pair at/after i
        z = (data[i:-1] == 0) & (data[i + 1:] == 0) if i < n - 1 else \
            np.zeros(0, bool)
        hits = np.nonzero(z)[0]
        if hits.size == 0:
            break
        j = i + int(hits[0])
        if j + 2 < n and data[j + 2] <= 3:
            out.append(data[start:j + 2].tobytes())
            out.append(b"\x03")
            start = j + 2
            i = j + 2
        else:
            i = j + 2 if j + 2 < n else n
    out.append(data[start:].tobytes())
    return b"".join(out)


def _nal(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return (b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | nal_type])
            + _emulation_prevent(rbsp))


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """f32/u8 RGB [H, W, 3] (or [3, H, W]) -> studio-range BT.601 YUV
    4:2:0 (Y [H, W], Cb/Cr [H/2, W/2] u8). H and W must be even."""
    if rgb.ndim == 3 and rgb.shape[0] == 3:
        rgb = np.moveaxis(rgb, 0, -1)
    rgb = np.asarray(rgb, np.float32)
    if rgb.max() > 1.5:                    # u8-ranged input
        rgb = rgb / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + 219.0 * (0.299 * r + 0.587 * g + 0.114 * b)
    cb = 128.0 + 224.0 * (-0.168736 * r - 0.331264 * g + 0.5 * b)
    cr = 128.0 + 224.0 * (0.5 * r - 0.418688 * g - 0.081312 * b)
    sub = lambda c: (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                     + c[1::2, 1::2]) * 0.25
    clip = lambda c, hi: np.clip(np.rint(c), 16, hi).astype(np.uint8)
    return clip(y, 235), clip(sub(cb), 240), clip(sub(cr), 240)


# (level_idc, MaxFS macroblocks/frame) — ITU-T H.264 Table A-1; the
# signaled level must admit the frame size or strict decoders reject it
_LEVEL_MAXFS = ((10, 99), (11, 396), (21, 792), (22, 1620), (31, 3600),
                (32, 5120), (40, 8192), (42, 8704), (50, 22080),
                (51, 36864))


class H264IPCMWriter:
    """All-intra I_PCM H.264 elementary-stream writer.

    >>> w = H264IPCMWriter(width, height, fps=30.0)
    >>> stream = w.headers() + w.encode_frame(y, cb, cr) + ...
    """

    def __init__(self, width: int, height: int,
                 level_idc: Optional[int] = None, fps: float = 30.0):
        if width % 2 or height % 2:
            raise ValueError("H.264 4:2:0 needs even frame dimensions")
        self.width = width
        self.height = height
        self.mb_w = -(-width // 16)
        self.mb_h = -(-height // 16)
        if level_idc is None:
            mbs = self.mb_w * self.mb_h
            level_idc = next((lv for lv, maxfs in _LEVEL_MAXFS
                              if maxfs >= mbs), None)
            if level_idc is None:
                raise ValueError(
                    f"{width}x{height} ({mbs} MBs) exceeds level 5.1's "
                    "frame-size limit")
        self.level_idc = level_idc
        self.fps = float(fps)
        self._idr_flip = 0

    # ------------------------------------------------------------ headers

    def sps(self) -> bytes:
        w = BitWriter()
        w.u(66, 8)                          # profile_idc: Baseline
        w.u(0, 8)                           # constraint flags + reserved
        w.u(self.level_idc, 8)
        w.ue(0)                             # seq_parameter_set_id
        w.ue(0)                             # log2_max_frame_num_minus4
        w.ue(2)                             # pic_order_cnt_type
        w.ue(0)                             # max_num_ref_frames
        w.u(0, 1)                           # gaps_in_frame_num allowed
        w.ue(self.mb_w - 1)                 # pic_width_in_mbs_minus1
        w.ue(self.mb_h - 1)                 # pic_height_in_map_units_m1
        w.u(1, 1)                           # frame_mbs_only_flag
        w.u(1, 1)                           # direct_8x8_inference_flag
        crop_r = (self.mb_w * 16 - self.width) // 2
        crop_b = (self.mb_h * 16 - self.height) // 2
        if crop_r or crop_b:
            w.u(1, 1)                       # frame_cropping_flag
            w.ue(0).ue(crop_r).ue(0).ue(crop_b)
        else:
            w.u(0, 1)
        # VUI with timing only, so players honor the requested fps
        # (field-based ticks: fps = time_scale / (2 * num_units_in_tick))
        w.u(1, 1)                           # vui_parameters_present_flag
        w.u(0, 1)                           # aspect_ratio_info_present
        w.u(0, 1)                           # overscan_info_present
        w.u(0, 1)                           # video_signal_type_present
        w.u(0, 1)                           # chroma_loc_info_present
        w.u(1, 1)                           # timing_info_present_flag
        w.u(1000, 32)                       # num_units_in_tick
        w.u(max(1, int(round(self.fps * 2000.0))), 32)  # time_scale
        w.u(1, 1)                           # fixed_frame_rate_flag
        w.u(0, 1)                           # nal_hrd_parameters_present
        w.u(0, 1)                           # vcl_hrd_parameters_present
        w.u(0, 1)                           # pic_struct_present_flag
        w.u(0, 1)                           # bitstream_restriction_flag
        w.rbsp_trailing()
        return _nal(7, w.getvalue())

    def pps(self) -> bytes:
        w = BitWriter()
        w.ue(0)                             # pic_parameter_set_id
        w.ue(0)                             # seq_parameter_set_id
        w.u(0, 1)                           # entropy_coding_mode: CAVLC
        w.u(0, 1)                           # bottom_field_poc_present
        w.ue(0)                             # num_slice_groups_minus1
        w.ue(0).ue(0)                       # num_ref_idx_l0/l1_minus1
        w.u(0, 1)                           # weighted_pred_flag
        w.u(0, 2)                           # weighted_bipred_idc
        w.se(0)                             # pic_init_qp_minus26
        w.se(0)                             # pic_init_qs_minus26
        w.se(0)                             # chroma_qp_index_offset
        w.u(0, 1)                           # deblocking_control_present
        w.u(0, 1)                           # constrained_intra_pred
        w.u(0, 1)                           # redundant_pic_cnt_present
        w.rbsp_trailing()
        return _nal(8, w.getvalue())

    def headers(self) -> bytes:
        return self.sps() + self.pps()

    # ------------------------------------------------------------- frames

    def _pad(self, plane: np.ndarray, mb: int) -> np.ndarray:
        ph, pw = self.mb_h * mb, self.mb_w * mb
        return np.pad(plane, ((0, ph - plane.shape[0]),
                              (0, pw - plane.shape[1])), mode="edge")

    def encode_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                     ) -> bytes:
        """One IDR access unit from studio-range planes (Y [H, W],
        Cb/Cr [H/2, W/2], u8). Returns the Annex-B NAL bytes."""
        if y.shape != (self.height, self.width):
            raise ValueError(f"luma shape {y.shape} != "
                             f"{(self.height, self.width)}")
        yp = self._pad(np.asarray(y, np.uint8), 16)
        cbp = self._pad(np.asarray(cb, np.uint8), 8)
        crp = self._pad(np.asarray(cr, np.uint8), 8)

        w = BitWriter()
        # slice_header (IDR, I slice)
        w.ue(0)                             # first_mb_in_slice
        w.ue(7)                             # slice_type: I (all slices)
        w.ue(0)                             # pic_parameter_set_id
        w.u(0, 4)                           # frame_num (log2 max = 4 bits)
        w.ue(self._idr_flip)                # idr_pic_id
        self._idr_flip ^= 1                 # consecutive IDRs must differ
        # dec_ref_pic_marking (IDR form)
        w.u(0, 1)                           # no_output_of_prior_pics
        w.u(0, 1)                           # long_term_reference_flag
        w.se(0)                             # slice_qp_delta
        # slice_data: raster-order I_PCM macroblocks
        for my in range(self.mb_h):
            for mx in range(self.mb_w):
                w.ue(25)                    # mb_type: I_PCM
                w.align_zero()              # pcm_alignment_zero_bit(s)
                w.raw(yp[my * 16:(my + 1) * 16,
                         mx * 16:(mx + 1) * 16].tobytes())
                w.raw(cbp[my * 8:(my + 1) * 8,
                          mx * 8:(mx + 1) * 8].tobytes())
                w.raw(crp[my * 8:(my + 1) * 8,
                          mx * 8:(mx + 1) * 8].tobytes())
        w.rbsp_trailing()
        return _nal(5, w.getvalue())

    def encode_rgb(self, rgb: np.ndarray) -> bytes:
        return self.encode_frame(*rgb_to_yuv420(rgb))


def h264_sink(path: str, gamma: float = 2.2, fps: float = 30.0):
    """Frame sink writing a raw .h264 Annex-B elementary stream via the
    I_PCM writer — the always-available real-H264 movie sink (players:
    `ffplay out.h264`, VLC, mpv; fps is signaled via SPS VUI timing).
    Call with f32[4|3, H, W] CHW (premultiplied session payloads) or
    [H, W, 3] HWC frames; `close()` (or use as a context manager)
    finishes the file."""

    class _Sink:
        def __init__(self):
            self.writer: Optional[H264IPCMWriter] = None
            self.f = open(path, "wb")
            self.frames = 0
            self.codec = "h264_ipcm"

        def __call__(self, frame: np.ndarray, meta=None) -> None:
            img = _host(frame)
            if img.ndim != 3:
                raise ValueError(f"expected a 3-d frame, got {img.shape}")
            if img.shape[0] in (3, 4) and img.shape[-1] not in (3, 4):
                img = np.moveaxis(img[:3], 0, -1)      # CHW -> HWC
            elif img.shape[-1] == 4:
                img = img[..., :3]
            elif img.shape[-1] != 3:
                raise ValueError(f"no 3/4-channel axis in {img.shape}")
            img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
            h, we = img.shape[0] & ~1, img.shape[1] & ~1
            img = img[:h, :we]
            if self.writer is None:
                self.writer = H264IPCMWriter(we, h, fps=fps)
                self.f.write(self.writer.headers())
            self.f.write(self.writer.encode_rgb(img))
            self.frames += 1

        def close(self) -> None:
            if not self.f.closed:
                self.f.close()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    return _Sink()
