"""ctypes bindings for the native C++ video decode core (``native/video_loader.cc``).

The port binds the same checked-in ``native/libvvt_data.so`` as the JAX
package, found from the repository root. Decoding runs outside the GIL, so
one process's thread pool keeps the host cores busy. ``available()`` is
False where the library or the OpenCV libraries it links are missing (the
GPU machine has no OpenCV); the pipeline's ``auto`` backend then takes the
threaded loader. Rebuild with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libvvt_data.so",
)

_lib = None


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.vvt_load_video.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.vvt_load_video.restype = ctypes.c_int
    lib.vvt_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.vvt_load_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load_library() is not None


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_video_native(
    path: str,
    max_frames: int,
    resize: Tuple[int, int],
    crop_size: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (video (T,H,W,3) f32, mask (T,) f32, status). status!=0 = failure."""
    lib = _load_library()
    assert lib is not None, "native library not built (make -C native)"
    h, w = resize
    video = np.empty((max_frames, h, w, 3), np.float32)
    mask = np.empty((max_frames,), np.float32)
    rc = lib.vvt_load_video(
        path.encode(), max_frames, h, w, crop_size,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), _fptr(video), _fptr(mask),
    )
    return video, mask, rc


def load_batch_native(
    paths: List[str],
    max_frames: int,
    resize: Tuple[int, int],
    crop_size: int,
    seeds: List[int],
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concurrent decode of a whole batch. Returns (videos, masks, statuses)."""
    lib = _load_library()
    assert lib is not None, "native library not built (make -C native)"
    n = len(paths)
    h, w = resize
    videos = np.empty((n, max_frames, h, w, 3), np.float32)
    masks = np.empty((n, max_frames), np.float32)
    errors = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_seeds = (ctypes.c_uint64 * n)(*[s & 0xFFFFFFFFFFFFFFFF for s in seeds])
    lib.vvt_load_batch(
        c_paths, n, max_frames, h, w, crop_size, c_seeds,
        _fptr(videos), _fptr(masks),
        errors.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads,
    )
    return videos, masks, errors
