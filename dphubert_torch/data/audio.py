"""Audio decoding (a copy of the TPU package's ``data/audio.py``).

The reference delegates decode to torchaudio/libsox (``audio_dataset.py:273``).
Here decode is host-side CPU work feeding the card:

  * native path: ``libdpaudio`` (C++, ``dphubert_torch/csrc/audio_decoder.cpp``)
    decodes WAV and FLAC with the GIL released; it is built with ``g++`` at
    first use into ``build/audio/`` at the root of the checkout, under a
    name that carries a hash of the source and flags;
  * fallback: a pure-numpy WAV (PCM16/24/32/float) reader, so the pipeline
    works without the native build (FLAC requires the native decoder).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "audio_decoder.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "audio"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_LIB = None
_LIB_TRIED = False


def _build() -> Optional[pathlib.Path]:
    """The built library, compiled now if needed; None without a C++
    compiler or when the build fails."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libdpaudio-{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    except (OSError, subprocess.SubprocessError):
        return None
    return so


def _native_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.dpaudio_decode.argtypes = [
            ctypes.c_char_p,                     # path
            ctypes.POINTER(ctypes.c_float),      # out buffer (may be NULL)
            ctypes.c_long,                       # out capacity (samples)
            ctypes.POINTER(ctypes.c_long),       # num samples
            ctypes.POINTER(ctypes.c_int),        # sample rate
            ctypes.POINTER(ctypes.c_int),        # channels
        ]
        lib.dpaudio_decode.restype = ctypes.c_int
        lib.dpaudio_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dpaudio_info.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def _decode_native(path: str) -> Tuple[np.ndarray, int]:
    lib = _native_lib()
    n = ctypes.c_long(0)
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    rc = lib.dpaudio_info(path.encode(), ctypes.byref(n), ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"dpaudio_info failed ({rc}) for {path}")
    buf = np.empty(n.value * ch.value, dtype=np.float32)
    rc = lib.dpaudio_decode(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size,
        ctypes.byref(n),
        ctypes.byref(sr),
        ctypes.byref(ch),
    )
    if rc != 0:
        raise IOError(f"dpaudio_decode failed ({rc}) for {path}")
    wave = buf[: n.value * ch.value].reshape(n.value, ch.value)
    return wave.T.copy(), sr.value  # (channels, time)


# --- pure-python WAV --------------------------------------------------------


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise IOError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            if fmt is None:
                raise IOError("data chunk before fmt")
            audio_format, channels, sr, _, _, bps = fmt
            if audio_format == 3 and bps == 32:
                wave = np.frombuffer(body, dtype="<f4").astype(np.float32)
            elif audio_format == 1 and bps == 16:
                wave = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32768.0
            elif audio_format == 1 and bps == 32:
                wave = np.frombuffer(body, dtype="<i4").astype(np.float32) / 2147483648.0
            elif audio_format == 1 and bps == 24:
                raw = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
                ints = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                ints = (ints << 8) >> 8  # sign-extend
                wave = ints.astype(np.float32) / 8388608.0
            else:
                raise IOError(f"unsupported WAV format {audio_format}/{bps}bit")
            wave = wave.reshape(-1, channels).T
            return np.ascontiguousarray(wave), sr
        pos += 8 + size + (size & 1)
    raise IOError(f"no data chunk in {path}")


def load_audio(path) -> Tuple[np.ndarray, int]:
    """Decode to float32 (channels, time) + sample rate: the shape contract
    of ``torchaudio.load`` used by the reference dataset."""
    path = os.fspath(path)
    if _native_lib() is not None:
        return _decode_native(path)
    if path.lower().endswith(".wav"):
        return _read_wav(path)
    raise IOError(
        f"native decoder unavailable and pure-python fallback only handles "
        f".wav (FLAC needs a C++ compiler to build csrc/audio_decoder.cpp): {path}"
    )


def audio_info(path) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels) without decoding the payload:
    the ``torchaudio.info`` equivalent used by manifest creation."""
    path = os.fspath(path)
    lib = _native_lib()
    if lib is not None:
        n = ctypes.c_long(0)
        sr = ctypes.c_int(0)
        ch = ctypes.c_int(0)
        rc = lib.dpaudio_info(path.encode(), ctypes.byref(n), ctypes.byref(sr), ctypes.byref(ch))
        if rc == 0:
            return n.value, sr.value, ch.value
    wave, sr = load_audio(path)
    return wave.shape[1], sr, wave.shape[0]
