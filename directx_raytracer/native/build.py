"""Build + bind the native runtime library (parser.cpp via g++ and ctypes).

The shared library is compiled on first use into ``_build/libcrtscene.so``
next to this file and rebuilt whenever parser.cpp is newer.  Binding is
plain ctypes (no pybind11 in the image); all arrays cross the boundary as
caller-allocated numpy buffers.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("directx_raytracer")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "parser.cpp")
_OUT_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_OUT_DIR, "libcrtscene.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compile() -> bool:
    os.makedirs(_OUT_DIR, exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        out = getattr(e, "stderr", str(e))
        log.warning("native parser build failed (%s); using Python parser", out)
        return False


def get_library():
    """The bound ctypes library, or None (Python fallback) if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            fresh = os.path.exists(_LIB) and (
                os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
            )
            if not fresh and not _compile():
                _lib_failed = True
                return None
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            log.warning("native parser unavailable: %s", e)
            _lib_failed = True
            return None

        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.crt_parse.restype = ctypes.c_void_p
        lib.crt_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.crt_free.argtypes = [ctypes.c_void_p]
        lib.crt_settings.argtypes = [ctypes.c_void_p, c_float_p, c_int_p, c_int_p]
        lib.crt_camera.restype = ctypes.c_int
        lib.crt_camera.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
        lib.crt_num_lights.restype = ctypes.c_int
        lib.crt_num_lights.argtypes = [ctypes.c_void_p]
        lib.crt_lights.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
        lib.crt_num_materials.restype = ctypes.c_int
        lib.crt_num_materials.argtypes = [ctypes.c_void_p]
        lib.crt_material.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            c_float_p, c_int_p, c_float_p, ctypes.c_char_p, ctypes.c_int,
            c_int_p, c_float_p,
        ]
        lib.crt_num_textures.restype = ctypes.c_int
        lib.crt_num_textures.argtypes = [ctypes.c_void_p]
        lib.crt_texture.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, c_float_p, c_float_p, c_float_p,
            c_float_p, c_float_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.crt_num_objects.restype = ctypes.c_int
        lib.crt_num_objects.argtypes = [ctypes.c_void_p]
        lib.crt_object_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int, c_int_p, c_int_p, c_int_p, c_int_p,
        ]
        lib.crt_object_data.argtypes = [
            ctypes.c_void_p, ctypes.c_int, c_float_p, c_int_p, c_float_p,
        ]
        lib.crt_vertex_normals.argtypes = [
            c_float_p, ctypes.c_int, c_int_p, ctypes.c_int, c_float_p,
        ]
        _lib = lib
        return _lib


def fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def vertex_normals(lib, verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    tris = np.ascontiguousarray(tris, np.int32).reshape(-1)
    out = np.empty_like(verts)
    lib.crt_vertex_normals(fptr(verts), len(verts), iptr(tris), len(tris) // 3,
                           fptr(out))
    return out
