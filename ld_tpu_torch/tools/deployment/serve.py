#!/usr/bin/env python
"""Inference server with dynamic request batching over the detector (the
counterpart of tools/deployment/serve.py).

A dispatcher thread coalesces the queued requests into the smallest
power-of-two batch that holds them, up to --max-batch: batch-1 latency when
idle, batched throughput under load. The server runs each batch size once
before it accepts traffic (cuDNN's algorithm choice and the NMS kernel's
build happen there, where the JAX server compiles). Runs on the card unless
`--device cpu` is given.

    python ld_tpu_torch/tools/deployment/serve.py CONFIG CHECKPOINT \
        --port 8080 --max-batch 4
    curl -X POST --data-binary @dog.jpg localhost:8080/predict
"""
from __future__ import annotations

import argparse
import io
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def preprocess(data: bytes, hw):
    """An encoded image -> (the normalised (h, w, 3) float32 canvas, the
    resized image's (nh, nw), the resize scale): RGB, resized with PIL to
    fit `hw` keeping its aspect ratio, normalised, on a zero canvas."""
    import numpy as np
    from PIL import Image
    h, w = hw
    img = Image.open(io.BytesIO(data)).convert('RGB')
    ow, oh = img.size
    scale = min(h / oh, w / ow)
    nh, nw = int(round(oh * scale)), int(round(ow * scale))
    arr = np.asarray(img.resize((nw, nh)), np.float32)
    canvas = np.zeros((h, w, 3), np.float32)
    canvas[:nh, :nw] = (arr - np.asarray(MEAN, np.float32)) / np.asarray(
        STD, np.float32)
    return canvas, (float(nh), float(nw)), scale


def detections(dets, labels, scale, score_thr):
    """One image's (max_per_img, 5) dets and labels -> the JSON records
    scoring at least `score_thr`, in the request image's coordinates."""
    keep = (dets[:, 4] >= score_thr) & (labels >= 0) & (dets[:, 4] > 0)
    return [dict(bbox=[float(v) / scale for v in d[:4]], score=float(d[4]),
                 label=int(lab))
            for d, lab in zip(dets[keep], labels[keep])]


class _Request:
    __slots__ = ('image', 'hw', 'done', 'dets', 'labels', 'batch', 'slot',
                 'size')

    def __init__(self, image, hw):
        self.image = image          # (h, w, 3) normalized float32
        self.hw = hw                # valid (nh, nw) before padding
        self.done = threading.Event()
        self.dets = self.labels = None
        # the batch it ran in: its index in `Batcher.formed`, its slot
        # there and the padded batch size
        self.batch = self.slot = self.size = None


class Batcher:
    """Coalesce requests into the smallest warmed batch size that holds
    them. `infer(images (B, h, w, 3), img_hw (B, 2))`, numpy in, returns
    numpy (dets, labels, valid). The number of requests of each batch
    formed is in `formed`, and its `infer` ms in `infer_ms`, in order; a
    reply's `X-Batch` header names its batch, slot and padded size."""

    def __init__(self, infer, hw, sizes, window_s=0.004):
        self.infer = infer
        self.h, self.w = hw
        self.sizes = sorted(sizes)
        self.window_s = window_s
        self.formed = []
        self.infer_ms = []
        self.q = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image, hw) -> _Request:
        """Queue one request and wait for its batch; returns it with its
        `dets` and `labels` (None and the error's text after a failure)."""
        req = _Request(image, hw)
        self.q.put(req)
        req.done.wait()
        return req

    def close(self):
        """Stop the dispatcher thread once the queued requests are done."""
        self.q.put(None)
        self._thread.join()

    def _collect(self):
        first = self.q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.sizes[-1]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self.q.put(None)      # stop after this batch
                break
            batch.append(req)
        return batch

    def _loop(self):
        import numpy as np
        while True:
            batch = self._collect()
            if batch is None:
                return
            size = next(s for s in self.sizes if s >= len(batch))
            self.formed.append(len(batch))
            images = np.zeros((size, self.h, self.w, 3), np.float32)
            hws = np.ones((size, 2), np.float32)
            for i, req in enumerate(batch):
                images[i] = req.image
                hws[i] = req.hw
                req.batch, req.slot, req.size = len(self.formed) - 1, i, size
            try:
                t0 = time.perf_counter()
                dets, labels, _ = self.infer(images, hws)
                self.infer_ms.append((time.perf_counter() - t0) * 1e3)
                for i, req in enumerate(batch):
                    req.dets, req.labels = dets[i], labels[i]
            except Exception as ex:  # a device error reaches the client
                for req in batch:
                    req.dets, req.labels = None, repr(ex)
            for req in batch:
                req.done.set()


class DetectionServer(ThreadingHTTPServer):
    """The HTTP server; `server_close` also stops its batcher."""
    daemon_threads = True
    batcher: Batcher = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def make_infer(model):
    """`infer` of a `Batcher` over `model.forward_test` on the model's
    device: NHWC numpy in, NCHW on the device, numpy out."""
    import torch
    device = next(model.parameters()).device

    def infer(images, img_hw):
        with torch.inference_mode():
            image = torch.from_numpy(images).to(device).permute(
                0, 3, 1, 2).contiguous()
            outs = model.forward_test(dict(
                image=image, img_hw=torch.from_numpy(img_hw).to(device)))
            return tuple(o.cpu().numpy() for o in outs)
    return infer


def make_server(config, checkpoint, input_size=(800, 1344), max_batch=4,
                score_thr=0.3, port=8080, window_ms=4.0, device=None):
    """Build (but do not start) the HTTP server, every batch size already
    run once. `config` is a path or a Config."""
    import numpy as np
    import PIL  # noqa: F401 — requests are decoded with PIL

    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.models.detectors.two_stage import reject_mask_head

    h, w = input_size
    model = init_detector(config, checkpoint, device=device)
    reject_mask_head(model, 'serve.py')
    infer = make_infer(model)
    sizes = [1]
    while sizes[-1] < max_batch:
        sizes.append(min(sizes[-1] * 2, max_batch))
    for s in sizes:   # cuDNN's algorithms, the NMS kernel's build
        infer(np.zeros((s, h, w, 3), np.float32),
              np.asarray([[float(h), float(w)]] * s, np.float32))
    batcher = Batcher(infer, (h, w), sizes, window_s=window_ms / 1e3)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != '/predict':
                self.send_error(404)
                return
            n = int(self.headers.get('Content-Length', 0))
            canvas, hw, scale = preprocess(self.rfile.read(n), (h, w))
            req = batcher.submit(canvas, hw)
            if req.dets is None:
                self.send_error(500, explain=str(req.labels))
                return
            body = json.dumps(dict(detections=detections(
                req.dets, req.labels, scale, score_thr))).encode()
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            # the batch the request ran in: index, slot, padded size
            self.send_header('X-Batch', f'{req.batch} {req.slot} {req.size}')
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = DetectionServer(('0.0.0.0', port), Handler)
    server.batcher = batcher
    server.model = model
    server.infer = infer
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('checkpoint', nargs='?', default=None)
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--input-size', type=int, nargs=2, default=(800, 1344))
    ap.add_argument('--score-thr', type=float, default=0.3)
    ap.add_argument('--max-batch', type=int, default=4,
                    help='largest coalesced batch (power-of-two sizes up '
                         'to this are run once before serving)')
    ap.add_argument('--batch-window-ms', type=float, default=4.0,
                    help='how long the dispatcher waits to fill a batch')
    ap.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = ap.parse_args(argv)

    server = make_server(args.config, args.checkpoint,
                         tuple(args.input_size), args.max_batch,
                         args.score_thr, args.port, args.batch_window_ms,
                         args.device)
    h, w = args.input_size
    print(f'serving on :{server.server_address[1]} (input {h}x{w}, '
          f'max batch {args.max_batch})', flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
