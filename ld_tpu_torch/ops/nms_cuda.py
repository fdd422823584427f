"""Greedy-NMS keep mask: the hand-written CUDA kernel and its plain version.

`nms_keep` replaces the Pallas TPU kernel `_nms_fixpoint_kernel`
(`ld_tpu/ops/pallas_nms.py:23`, launched by `pallas_nms_keep`). On a CUDA
tensor it launches `csrc/nms_keep.cu` (design notes there) or raises; on a CPU
tensor it takes `nms_keep_ref`, the PyTorch mirror of the JAX fixpoint
`ld_tpu/ops/nms.py::_cluster_nms_keep`. Both give the same bits.

Both are the implementations of one registered operator,
`torch.ops.ld_tpu_torch.nms_keep` (`torch.library.custom_op`), with a fake
implementation that gives the (B, K) bool shape. `nms_keep` checks its
arguments and calls it, so `torch.export` keeps the keep mask as one node of
the exported graph instead of tracing into the ctypes call; a program that
loads such a graph imports this module to register the operator.

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
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.nms_keep_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.nms_keep_error_string.argtypes = [ctypes.c_int]
            lib.nms_keep_error_string.restype = ctypes.c_char_p
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
    keep = valid.clone()     # an operator's output never aliases its input
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

    Calls the registered operator `ld_tpu_torch::nms_keep`: a CUDA tensor
    launches the kernel (counted in `nms_keep.launches`) or raises; a CPU
    tensor takes `nms_keep_ref`.
    """
    _check(boxes, valid)
    return torch.ops.ld_tpu_torch.nms_keep(boxes, valid, float(iou_threshold))


nms_keep.launches = 0


@torch.library.custom_op('ld_tpu_torch::nms_keep', mutates_args=(),
                         device_types='cpu')
def _nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    return nms_keep_ref(boxes, valid, iou_threshold)


@_nms_keep_op.register_kernel('cuda')
def launch(boxes: torch.Tensor, valid: torch.Tensor,
           iou_threshold: float) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (the operator's CUDA
    implementation), counted in `nms_keep.launches`; raises on a failed
    build or launch."""
    _check(boxes, valid)
    device = boxes.device
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError('nms_keep needs contiguous boxes and valid')
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    if b == 0 or k == 0:
        return keep
    lib = _load()
    words = (k + 63) // 64
    # the upper-triangle tiles of 64 words, W(W+1)/2 per image
    mask = torch.empty((b, words * (words + 1) // 2 * 64), dtype=torch.int64,
                       device=device)
    # the raw current stream: torch.cuda.current_stream() builds a Stream
    # object per call, and at K = 1024 this wrapper's host time already
    # matches the two kernels' device time
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = lib.nms_keep_launch(boxes.data_ptr(), valid.data_ptr(), b, k,
                              float(iou_threshold), mask.data_ptr(),
                              keep.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(
            f'nms_keep kernel launch failed at B = {b}, K = {k}: CUDA error '
            f'{err} ({lib.nms_keep_error_string(err).decode()})')
    nms_keep.launches += 1
    return keep


@_nms_keep_op.register_fake
def _nms_keep_fake(boxes, valid, iou_threshold):
    return torch.empty(valid.shape, dtype=torch.bool, device=valid.device)
