"""Frames read ahead of the tracker (port of
gf_orb_slam_tpu/io_utils/prefetch.py): the native reader
`native/libgfslam_io.so` through ctypes, read by path as the vocabulary is,
or a Python thread with io_utils/images.py where the library cannot run.

    with FramePrefetcher(seq.image_paths, width, height) as pf:
        for idx, img in pf:            # img: float32 (H, W) numpy
            ...

The library is a build for one host (`native/build.sh`: -march=native,
libpng16). It is used only after a child process has loaded it and decoded
a PNG and a PGM with it and its prefetcher: where libpng16 is missing the
load fails, and where the CPU lacks an instruction of the build the child,
not this process, dies.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import sys
import tempfile
import threading

import numpy as np

from gf_orb_slam_tpu_torch.io_utils.images import read_gray, write_gray

NATIVE_SO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native", "libgfslam_io.so"))
_NATIVE: dict = {}  # "lib": the checked library or None, once probed

_PROBE = r"""
import ctypes, sys
so, png, pgm = sys.argv[1:4]
lib = ctypes.CDLL(so)
buf = (ctypes.c_float * 64)()
w, h = ctypes.c_int(), ctypes.c_int()
for p in (png, pgm):
    assert lib.io_decode_gray(p.encode(), buf, 64, ctypes.byref(w), ctypes.byref(h)) == 0
    assert (w.value, h.value) == (4, 3) and [buf[i] for i in range(12)] == [float(7 * i) for i in range(12)]
lib.io_prefetcher_create.restype = ctypes.c_void_p
lib.io_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
lib.io_prefetcher_destroy.argtypes = [ctypes.c_void_p]
paths = (ctypes.c_char_p * 2)(png.encode(), pgm.encode())
hd = lib.io_prefetcher_create(paths, 2, 4, 3, 2, 2)
assert [lib.io_prefetcher_next(hd, buf) for _ in range(3)] == [0, 1, -1]
lib.io_prefetcher_destroy(hd)
print("ok")
"""


def _bind(lib):
    lib.io_decode_gray.restype = ctypes.c_int
    lib.io_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.io_prefetcher_create.restype = ctypes.c_void_p
    lib.io_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.io_prefetcher_next.restype = ctypes.c_int
    lib.io_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.io_prefetcher_destroy.restype = None
    lib.io_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load_native():
    """The native library, once a child process has run it, or None."""
    if "lib" not in _NATIVE:
        _NATIVE["lib"] = None
        if os.path.exists(NATIVE_SO):
            with tempfile.TemporaryDirectory(prefix="gfslam_io_") as tmp:
                img = (7 * np.arange(12, dtype=np.uint8)).reshape(3, 4)
                png, pgm = os.path.join(tmp, "probe.png"), os.path.join(tmp, "probe.pgm")
                write_gray(png, img)
                write_gray(pgm, img)
                try:
                    probe = subprocess.run([sys.executable, "-c", _PROBE, NATIVE_SO, png, pgm],
                                           capture_output=True, text=True, timeout=60)
                    usable = probe.returncode == 0 and probe.stdout.strip() == "ok"
                except subprocess.TimeoutExpired:
                    usable = False
            if usable:
                _NATIVE["lib"] = _bind(ctypes.CDLL(NATIVE_SO))
    return _NATIVE["lib"]


def native_available() -> bool:
    return _load_native() is not None


def decode_gray(path: str) -> np.ndarray | None:
    """One-shot native decode to float32; None if the library is
    unavailable or the decode failed."""
    lib = _load_native()
    if lib is None:
        return None
    cap = 8192 * 8192
    buf = np.empty(cap, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.io_decode_gray(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            cap, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class FramePrefetcher:
    """Ordered multi-threaded frame prefetch; native C++ where it runs."""

    def __init__(self, paths: list[str], width: int, height: int, queue_depth: int = 8, n_threads: int = 2):
        self.paths = paths
        self.width = width
        self.height = height
        self.queue_depth = queue_depth
        self.n_threads = n_threads
        self._lib = _load_native()
        self._handle = None
        self._py_queue: queue.Queue | None = None
        self._py_thread = None
        self._stop = threading.Event()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __enter__(self):
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._paths_keepalive = arr
            self._handle = self._lib.io_prefetcher_create(arr, len(self.paths), self.width, self.height,
                                                          self.queue_depth, self.n_threads)
        else:
            self._py_queue = queue.Queue(maxsize=self.queue_depth)

            def put(item) -> bool:
                while not self._stop.is_set():
                    try:
                        self._py_queue.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def worker():
                for i, p in enumerate(self.paths):
                    try:
                        item = (i, read_gray(p).astype(np.float32))
                    except (OSError, ValueError) as e:
                        item = (i, e)
                    if not put(item):
                        return
                put((-1, None))

            self._py_thread = threading.Thread(target=worker, daemon=True)
            self._py_thread.start()
        return self

    def __iter__(self):
        if self._handle is not None:
            buf = np.empty(self.height * self.width, np.float32)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            while True:
                rc = self._lib.io_prefetcher_next(self._handle, ptr)
                if rc == -1:
                    return
                if rc < -1:
                    raise IOError(f"failed to decode frame {-(rc + 2)}")
                yield rc, buf.reshape(self.height, self.width).copy()
        else:
            while True:
                i, img = self._py_queue.get()
                if i < 0:
                    return
                if isinstance(img, Exception):
                    raise IOError(f"failed to decode frame {i}: {img}") from img
                if img.shape != (self.height, self.width):
                    raise IOError(f"frame {i} is {img.shape[1]}x{img.shape[0]}, not {self.width}x{self.height}")
                yield i, img

    def __exit__(self, *exc):
        if self._handle is not None:
            self._lib.io_prefetcher_destroy(self._handle)
            self._handle = None
        if self._py_thread is not None:
            self._stop.set()
            self._py_thread.join(timeout=10)
            self._py_thread = None
        return False
