#!/usr/bin/env python
"""Run a detector exported by export.py without the framework (the
counterpart of tools/deployment/run_stablehlo.py).

The `.pt2` artifact is self-contained: weights inside, decode and NMS
included. Loading it needs torch and one module of ld_tpu_torch, which is
the one difference from `run_stablehlo.py`: `ld_tpu_torch/ops/nms_cuda.py`,
loaded here from its file alone (no other module of the package), because
it registers the `ld_tpu_torch::nms_keep` operator that the graph calls
(the CUDA kernel, or its plain version on the CPU). The program runs on the
device it was exported on.

    python ld_tpu_torch/tools/deployment/export.py CONFIG CKPT --out det.pt2
    python ld_tpu_torch/tools/deployment/run_export.py det.pt2 \
        --image demo/demo.jpg

Prints the detections scoring at least --score-thr as JSON, in the
image's coordinates.
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
NMS_MODULE = 'ld_tpu_torch.ops.nms_cuda'


def register_nms_op():
    """Load `ld_tpu_torch/ops/nms_cuda.py` under its own name unless it is
    loaded already (a process that imported the package registered the
    operator then); returns the module."""
    if NMS_MODULE in sys.modules:
        return sys.modules[NMS_MODULE]
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'ops', 'nms_cuda.py')
    spec = importlib.util.spec_from_file_location(NMS_MODULE, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[NMS_MODULE] = module
    spec.loader.exec_module(module)
    return module


def load_input(image, hw):
    """(canvas (h, w, 3) float32, resized (nh, nw), scale) of an image
    file, resized with PIL to fit and normalised as serve.py does; a
    seeded random canvas without one."""
    h, w = hw
    if image is None:
        canvas = np.random.RandomState(0).randn(h, w, 3).astype(np.float32)
        return canvas, (float(h), float(w)), 1.0
    from PIL import Image
    img = Image.open(image).convert('RGB')
    ow, oh = img.size
    scale = min(h / oh, w / ow)
    nh, nw = int(round(oh * scale)), int(round(ow * scale))
    arr = np.asarray(img.resize((nw, nh)), np.float32)
    canvas = np.zeros((h, w, 3), np.float32)
    canvas[:nh, :nw] = (arr - np.asarray(MEAN, np.float32)) / np.asarray(
        STD, np.float32)
    return canvas, (float(nh), float(nw)), scale


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('artifact', help='.pt2 from export.py')
    ap.add_argument('--image', default=None,
                    help='jpg/png to run; random input when omitted')
    ap.add_argument('--score-thr', type=float, default=0.3)
    args = ap.parse_args(argv)

    import torch
    register_nms_op()
    exported = torch.export.load(args.artifact)
    nodes = {n.name: n for n in exported.graph.nodes}
    image_spec = next(s for s in exported.graph_signature.input_specs
                      if s.kind.name == 'USER_INPUT')
    image_val = nodes[image_spec.arg.name].meta['val']
    _, _, h, w = image_val.shape
    device = image_val.device
    print(f'artifact input: {tuple(image_val.shape)} {image_val.dtype} on '
          f'{device}', file=sys.stderr)

    canvas, (nh, nw), scale = load_input(args.image, (h, w))
    with torch.inference_mode():
        dets, labels, _ = exported.module()(
            torch.from_numpy(canvas).permute(2, 0, 1)[None].contiguous()
            .to(device),
            torch.tensor([[nh, nw]], device=device))
    dets, labels = dets[0].cpu().numpy(), labels[0].cpu().numpy()
    keep = (dets[:, 4] >= args.score_thr) & (labels >= 0) & (dets[:, 4] > 0)
    out = dict(detections=[
        dict(bbox=[float(v) / scale for v in d[:4]], score=float(d[4]),
             label=int(lab)) for d, lab in zip(dets[keep], labels[keep])])
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
