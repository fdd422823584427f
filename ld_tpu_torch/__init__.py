"""ld_tpu_torch — the PyTorch/CUDA port of ld_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference `ld_tpu`, held against it in
`tests/test_torch_port_*.py`. It imports torch, never jax and nothing of
`ld_tpu`. Plain tensor code is PyTorch; each Pallas TPU kernel of the JAX
package becomes a kernel written by hand for sm_90a (`csrc/`).

Ported so far: GFL inference (ResNet -> FPN -> GFL head -> top-k, integral
decode -> class-aware NMS on the CUDA greedy-NMS kernel) through
`init_detector` / `inference_detector` / `forward_test`.
"""

__version__ = '0.1.0'

from ld_tpu_torch.utils.registry import (BACKBONES, DETECTORS, HEADS, NECKS,
                                         PIPELINES)
from ld_tpu_torch.utils.config import Config

# importing the subpackages populates the registries
import ld_tpu_torch.ops  # noqa: F401,E402
import ld_tpu_torch.models  # noqa: F401,E402
import ld_tpu_torch.data  # noqa: F401,E402

__all__ = ['BACKBONES', 'DETECTORS', 'HEADS', 'NECKS', 'PIPELINES', 'Config',
           '__version__']
