"""Greedy-NMS keep mask: the hand-written CUDA kernel and its plain version.

`nms_keep` replaces the Pallas TPU kernel `_nms_fixpoint_kernel`
(`ld_tpu/ops/pallas_nms.py:23`, launched by `pallas_nms_keep`). On a CUDA
tensor it launches `csrc/nms_keep.cu` (design notes there) or raises; on a CPU
tensor it takes `nms_keep_ref`, the PyTorch mirror of the JAX fixpoint
`ld_tpu/ops/nms.py::_cluster_nms_keep`. Both give the same bits.

The kernel is built at first use with nvcc for sm_90a into
`ld_tpu_torch/_build/` (one shared library per source hash) and bound with
ctypes through a plain C interface.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, 'csrc', 'nms_keep.cu')
_BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC')

_lib = None
_lib_lock = threading.Lock()


def _find_nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA NMS kernel cannot be '
                       'built')


def build() -> str:
    """Compile `csrc/nms_keep.cu` into `_build/` unless a library for this
    exact source is already there; returns the library's path."""
    with open(_SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    path = os.path.join(_BUILD_DIR, f'libnms_keep_{digest.hexdigest()[:12]}.so')
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)   # atomic: a concurrent build never sees a stub
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.nms_keep_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(boxes: torch.Tensor, valid: torch.Tensor):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be (B, K, 4), got {tuple(boxes.shape)}')
    if boxes.dtype != torch.float32:
        raise TypeError(f'boxes must be float32, got {boxes.dtype}')
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f'valid must be bool {tuple(boxes.shape[:2])}, got '
                         f'{valid.dtype} {tuple(valid.shape)}')
    if valid.device != boxes.device:
        raise ValueError(f'boxes on {boxes.device}, valid on {valid.device}')


def nms_keep_ref(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch keep mask: the suppression fixpoint of
    `ld_tpu/ops/nms.py::_cluster_nms_keep` (:95-117), batched.

    Builds the strict-upper-triangular IoU > thr matrix once, then iterates
    `keep <- valid & !(keep . S > 0.5)` until no image changes (at most K
    rounds); the fixpoint is exactly greedy NMS.

    Args:
        boxes: (B, K, 4) float32, each image sorted by descending score.
        valid: (B, K) bool; invalid entries are never kept.
    Returns:
        (B, K) bool keep mask.
    """
    _check(boxes, valid)
    k = boxes.shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    w = (torch.minimum(x2[:, :, None], x2[:, None, :]) -
         torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0)
    h = (torch.minimum(y2[:, :, None], y2[:, None, :]) -
         torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
    inter = w * h
    union = (area[:, :, None] + area[:, None, :] - inter).clamp(min=1e-6)
    thr = torch.tensor(iou_threshold, dtype=torch.float32,
                       device=boxes.device)
    tri = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = ((inter / union > thr) & tri).float()   # i suppresses j (i<j)
    keep = valid
    for _ in range(k):
        killed = torch.bmm(keep.float()[:, None, :], suppress)[:, 0] > 0.5
        new_keep = valid & ~killed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy-NMS keep mask over score-sorted boxes, batched over images.

    Args:
        boxes: (B, K, 4) float32 contiguous, each image sorted by descending
            score (class-offset by the caller for class-aware NMS).
        valid: (B, K) bool contiguous; invalid entries never keep and never
            suppress.
    Returns:
        (B, K) bool keep mask.

    A CUDA tensor launches the kernel (counted in `nms_keep.launches`); a CPU
    tensor takes `nms_keep_ref`.
    """
    _check(boxes, valid)
    if boxes.device.type == 'cpu':
        return nms_keep_ref(boxes, valid, iou_threshold)
    if boxes.device.type != 'cuda':
        raise ValueError(f'nms_keep runs on cuda or cpu, not {boxes.device}')
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError('nms_keep needs contiguous boxes and valid')
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _load()
    words = (k + 63) // 64
    with torch.cuda.device(boxes.device):
        mask = torch.empty((b, k, words), dtype=torch.int64,
                           device=boxes.device)
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_keep_launch(boxes.data_ptr(), valid.data_ptr(), b, k,
                                  float(iou_threshold), mask.data_ptr(),
                                  keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'nms_keep kernel launch failed: CUDA error {err}')
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
