"""The port's host-side native code: fused image preprocessing and the COCO
matcher, in C++ (`csrc/host/`), bound with ctypes.

Each source is built at first use with `g++ -O3 -shared -fPIC` into
`ld_tpu_torch/_build/`, one shared library per hash of the source and the
flags, so an edited source never loads a stale library. A failed build
raises: the port has no silent fallback. The numpy versions of the two
functions are their plain versions, which the tests hold them against.

ctypes releases the interpreter lock during each call, so the loader's
worker threads run `image_prep` in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, 'csrc', 'host')
_BUILD_DIR = os.path.join(_PKG_DIR, '_build')
GXX_FLAGS = ('-O3', '-shared', '-fPIC')

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
# (source, function, argtypes): the argtypes of ld_tpu/native/build.py
_LIBS = {
    'image_prep': ('image_prep.cpp', [_U8, _I64, _I64, _F32, _I64, _I64,
                                      _I64, _I64, _F32, _F32, ctypes.c_int]),
    'coco_match': ('coco_match.cpp', [_F64, _I64, _F64, _U8, _U8, _I64,
                                      _F64, _I64, _F64, _U8, _U8]),
}

_loaded = {}
_lock = threading.Lock()


def build(name: str) -> str:
    """Compile `csrc/host/<source of name>` into `_build/` unless a library
    for this exact source and these flags is already there; returns its
    path. Raises RuntimeError when g++ is missing or fails."""
    src = os.path.join(_SRC_DIR, _LIBS[name][0])
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(GXX_FLAGS).encode())
    path = os.path.join(_BUILD_DIR, f'lib{name}_{digest.hexdigest()[:12]}.so')
    if os.path.exists(path):
        return path
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(f'g++ not found: cannot build {src}')
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    proc = subprocess.run([gxx, *GXX_FLAGS, src, '-o', tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed ({proc.returncode}) on {src}:\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)   # atomic: a concurrent build never sees a stub
    return path


def load(name: str) -> ctypes.CDLL:
    """The built library of `name` ('image_prep' or 'coco_match'), with the
    argtypes of its one function declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build(name))
            fn = getattr(lib, name)
            fn.argtypes = _LIBS[name][1]
            fn.restype = None
            _loaded[name] = lib
    return _loaded[name]


def ptr(array, ctype):
    """A ctypes pointer of `ctype` to a contiguous numpy array's data."""
    return array.ctypes.data_as(ctypes.POINTER(ctype))
