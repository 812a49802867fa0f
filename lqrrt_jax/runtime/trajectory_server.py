"""ctypes binding + build driver for the native trajectory server.

``TrajectoryServer`` holds the committed plan in a C seqlock double buffer
(runtime/native/trajserver.c) so controller threads query get_state /
get_effort lock-free and GIL-independent at control rate while the planner
republishes at replan rate.  ``attach(planner)`` auto-publishes on every
update_plan via the planner's on_replan hook.

The .so is compiled on first use with the system C compiler and cached next
to the source; if no compiler is available the pure-Python planner queries
(lqrrt_jax/planner.py get_state/get_effort) remain the fallback — construct
TrajectoryServer(..., require_native=False) to silently no-op in that case.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "trajserver.c")
_SO = os.path.join(os.path.dirname(_SRC), "trajserver.so")
_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build_so() -> str:
    for cc in ("cc", "gcc", "g++", "clang"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", _SO, _SRC],
                check=True, capture_output=True)
            return _SO
        except (FileNotFoundError, subprocess.CalledProcessError):
            continue
    raise NativeUnavailable("no working C compiler for trajserver.so")


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _SO if os.path.exists(_SO) and os.path.getmtime(_SO) >= \
            os.path.getmtime(_SRC) else _build_so()
        lib = ctypes.CDLL(so)
        lib.ts_new.restype = ctypes.c_void_p
        lib.ts_new.argtypes = [ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
        lib.ts_free.argtypes = [ctypes.c_void_p]
        lib.ts_publish.restype = ctypes.c_int
        lib.ts_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_double]
        for fn in (lib.ts_state, lib.ts_effort):
            fn.restype = ctypes.c_ulong
            fn.argtypes = [ctypes.c_void_p, ctypes.c_double,
                           ctypes.c_void_p]
        lib.ts_duration.restype = ctypes.c_double
        lib.ts_duration.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class TrajectoryServer:
    """Single-publisher / many-reader plan store (reference C11 semantics:
    linear interpolation for both states and efforts, endpoint hold —
    matching Planner.get_state/get_effort and trajserver.c)."""

    def __init__(self, nstates: int, ncontrols: int, cap_steps: int = 8192):
        self._lib = _load()
        self.nstates = int(nstates)
        self.ncontrols = int(ncontrols)
        self.cap_steps = int(cap_steps)
        self._h = self._lib.ts_new(self.cap_steps, self.nstates,
                                   self.ncontrols)
        if not self._h:
            raise MemoryError("ts_new failed")

    def publish(self, x_seq, u_seq, dt: float):
        x = np.ascontiguousarray(x_seq, np.float32)
        u = np.ascontiguousarray(u_seq, np.float32)
        P = len(x)
        if x.shape != (P, self.nstates) or u.shape[0] not in (P - 1, 0):
            raise ValueError(f"bad plan shapes {x.shape} {u.shape}")
        rc = self._lib.ts_publish(
            self._h, x.ctypes.data_as(ctypes.c_void_p),
            u.ctypes.data_as(ctypes.c_void_p), P, float(dt))
        if rc != 0:
            raise ValueError(f"plan of {P} steps exceeds capacity "
                             f"{self.cap_steps}")

    def get_state(self, t: float) -> np.ndarray:
        out = np.empty(self.nstates, np.float32)
        v = self._lib.ts_state(self._h, float(t),
                               out.ctypes.data_as(ctypes.c_void_p))
        if v == 0:
            raise RuntimeError("no plan published")
        return out

    def get_effort(self, t: float) -> np.ndarray:
        out = np.empty(self.ncontrols, np.float32)
        v = self._lib.ts_effort(self._h, float(t),
                                out.ctypes.data_as(ctypes.c_void_p))
        if v == 0:
            raise RuntimeError("no plan published")
        return out

    @property
    def T(self) -> float:
        return float(self._lib.ts_duration(self._h))

    def attach(self, planner):
        """Auto-publish every committed plan (composes with any existing
        on_replan hook, e.g. a metrics sink)."""
        prev = planner.on_replan

        def hook(stats):
            self.publish(planner.x_seq, planner.u_seq, planner.dt)
            if prev is not None:
                prev(stats)

        planner.on_replan = hook
        if planner.x_seq is not None:
            self.publish(planner.x_seq, planner.u_seq, planner.dt)
        return self

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib:
            lib.ts_free(h)
            self._h = None
