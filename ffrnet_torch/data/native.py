"""ctypes binding of the native host-prep library (native/ffrnet_host.cpp).

The port's own binding of the library the JAX package uses
(ffrnet_tpu/data/native.py): JPEG decode (libjpeg) -> BGR -> bicubic
resize -> flip -> [-1, 1] floats or uint8, on a C++ thread pool.
`prep_batch` takes decoded uint8 RGB images, `decode_prep_batch` raw JPEG
bytes. The library is built on first use with `make -C native` under an
exclusive lock (a concurrent process must not open a half-written .so);
`is_available()` is False when it neither builds nor exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libffrnet_host.so")

_lib = None
_lock = threading.Lock()
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # make runs every time (it compares timestamps), so an edited source
        # never hides behind a stale binary
        try:
            import fcntl

            with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                               check=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(_SO_PATH):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.ffrnet_prep_batch.restype = ctypes.c_int
        lib.ffrnet_prep_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        lib.ffrnet_decode_prep_batch.restype = ctypes.c_int
        lib.ffrnet_decode_prep_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p]
        try:  # the uint8-output entry points (absent from a stale v1 library)
            lib.ffrnet_prep_batch_u8.restype = ctypes.c_int
            lib.ffrnet_prep_batch_u8.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
            lib.ffrnet_decode_prep_batch_u8.restype = ctypes.c_int
            lib.ffrnet_decode_prep_batch_u8.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p]
        except AttributeError:
            pass
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def has_u8() -> bool:
    """True when the library has the uint8-output entry points."""
    lib = _load()
    return lib is not None and hasattr(lib, "ffrnet_prep_batch_u8")


def _flip_buf(flips, n) -> bytes:
    return bytes(bytearray([1 if (flips is not None and flips[i]) else 0 for i in range(n)]))


def prep_batch(images: Sequence[np.ndarray], out_hw=(112, 112), *, bgr: bool = True,
               flips: Optional[Sequence[bool]] = None, out_u8: bool = False) -> np.ndarray:
    """uint8 RGB HWC images (any sizes) -> an NHWC batch: float32 in
    [-1, 1], or the uint8 pixels with out_u8=True."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    n = len(images)
    oh, ow = out_hw
    images = [np.ascontiguousarray(img, dtype=np.uint8) for img in images]
    for i, img in enumerate(images):
        # the library reads h*w*3 bytes of each image
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"images[{i}] must be HWC with 3 channels, got {img.shape}")
    ptrs = (ctypes.c_void_p * n)(*[img.ctypes.data_as(ctypes.c_void_p).value for img in images])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in images])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in images])
    flip_buf = _flip_buf(flips, n)
    if out_u8:
        if not has_u8():
            raise RuntimeError("native library lacks the uint8 entry points")
        out = np.empty((n, oh, ow, 3), np.uint8)
        rc = lib.ffrnet_prep_batch_u8(ptrs, hs, ws, n,
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                      oh, ow, 1 if bgr else 0, flip_buf)
    else:
        out = np.empty((n, oh, ow, 3), np.float32)
        rc = lib.ffrnet_prep_batch(ptrs, hs, ws, n,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   oh, ow, 1 if bgr else 0, flip_buf)
    if rc != 0:
        raise RuntimeError(f"ffrnet_prep_batch failed: {rc}")
    return out


def decode_prep_batch(jpeg_buffers: Sequence[bytes], out_hw=(112, 112), *, bgr: bool = True,
                      flips: Optional[Sequence[bool]] = None, strict: bool = False,
                      out_u8: bool = False) -> np.ndarray:
    """Raw JPEG buffers -> an NHWC batch: float32 in [-1, 1], or the uint8
    pixels with out_u8=True. A failed decode comes back as a zero image;
    strict=True raises on any failure (else only when all fail)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    n = len(jpeg_buffers)
    oh, ow = out_hw
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in jpeg_buffers]
    ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
    lens = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
    flip_buf = _flip_buf(flips, n)
    if out_u8:
        if not has_u8():
            raise RuntimeError("native library lacks the uint8 entry points")
        out = np.empty((n, oh, ow, 3), np.uint8)
        failures = lib.ffrnet_decode_prep_batch_u8(
            ptrs, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            oh, ow, 1 if bgr else 0, flip_buf)
    else:
        out = np.empty((n, oh, ow, 3), np.float32)
        failures = lib.ffrnet_decode_prep_batch(
            ptrs, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            oh, ow, 1 if bgr else 0, flip_buf)
    if failures and (strict or failures == n) and n > 0:
        raise RuntimeError(f"{failures}/{n} JPEG decodes failed")
    return out
