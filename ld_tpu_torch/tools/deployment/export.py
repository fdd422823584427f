#!/usr/bin/env python
"""Export a detector's `forward_test` with `torch.export` (the counterpart
of tools/deployment/export_stablehlo.py).

The artifact is one `.pt2` file: the exported program of a module that
wraps `forward_test` (decode and NMS included), with the weights inside,
for a (1, 3, h, w) image and its (1, 2) valid (h, w), on the device it was
exported on. The NMS keep mask stays one node, the registered operator
`ld_tpu_torch::nms_keep`, so the CUDA kernel runs in the exported program;
`run_export.py` loads and runs it. Exports on the card unless
`--device cpu` is given.

    python ld_tpu_torch/tools/deployment/export.py CONFIG CKPT \
        --out detector.pt2
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

import torch  # noqa: E402

from ld_tpu_torch.apis import init_detector  # noqa: E402
from ld_tpu_torch.models.detectors.two_stage import \
    reject_mask_head  # noqa: E402

NMS_OP = 'ld_tpu_torch.nms_keep.default'


class ForwardTest(torch.nn.Module):
    """`model.forward_test` on (image (B, 3, H, W), img_hw (B, 2)) ->
    (dets (B, 100, 5), labels, valid)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, image, img_hw):
        return self.model.forward_test(dict(image=image, img_hw=img_hw))


def export_detector(model, hw):
    """The exported program of `model.forward_test` at (1, 3, h, w) on the
    model's device."""
    reject_mask_head(model, 'export.py')
    device = next(model.parameters()).device
    h, w = hw
    with torch.no_grad():
        return torch.export.export(ForwardTest(model.eval()), (
            torch.zeros(1, 3, h, w, device=device),
            torch.tensor([[float(h), float(w)]], device=device)))


def nms_nodes(exported):
    """The exported graph's calls of the registered NMS operator."""
    return [n for n in exported.graph.nodes
            if n.op == 'call_function' and str(n.target) == NMS_OP]


def io_specs(exported):
    """(inputs, outputs) of the exported program as (name, shape, dtype)."""
    nodes = {n.name: n for n in exported.graph.nodes}
    sig = exported.graph_signature

    def spec(name):
        val = nodes[name].meta['val']
        return name, tuple(val.shape), str(val.dtype)
    return ([spec(s.arg.name) for s in sig.input_specs
             if s.kind.name == 'USER_INPUT'],
            [spec(s.arg.name) for s in sig.output_specs])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--shape', type=int, nargs=2, default=[800, 1344])
    p.add_argument('--out', default='detector.pt2')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = p.parse_args(argv)

    model = init_detector(args.config, args.checkpoint, device=args.device)
    t0 = time.perf_counter()
    exported = export_detector(model, args.shape)
    seconds = time.perf_counter() - t0
    torch.export.save(exported, args.out)
    inputs, outputs = io_specs(exported)
    print(f'exported in {seconds:.1f} s: {os.path.getsize(args.out) / 1e6:.1f}'
          f' MB -> {args.out} ({len(nms_nodes(exported))} '
          f'{NMS_OP} node)')
    print(f'inputs: {inputs}')
    print(f'outputs: {outputs}')
    return exported


if __name__ == '__main__':
    main()
