"""The port's deployment tools and the NMS kernel's binding as an operator:
  * `nms_keep` is the registered operator `ld_tpu_torch::nms_keep`
    (`torch.library.opcheck`: schema, fake implementation, dispatch), and
    the callers' default `keep_fn` reaches it;
  * `serve.make_server` on the synthetic R18 config (4 classes, 96x128,
    `max_batch=4`, a 50 ms window, port 0) answers 6 concurrent JPEG
    requests with 200, coalesces some into a batch of more than one (the
    replies' `X-Batch` headers name each batch's members), and each
    response's detections equal, within 1e-4, the same image run alone at
    batch 1 through the same preprocessing; another path is 404, a failing
    device 500;
  * `export.py` exports the synthetic R18 detector (FPN and head at width
    64) at 64x96 on the CPU with the NMS as one `ld_tpu_torch::nms_keep`
    node; the exported program equals eager `forward_test`, and
    `run_export.py` in a fresh interpreter gives detections within 1e-5 of
    eager `forward_test`'s with no module of jax, flax or ld_tpu loaded,
    and of ld_tpu_torch only `ld_tpu_torch.ops.nms_cuda`.
The detectors' `gfl_cls` bias is 0 and their `gfl_reg` bias favours the
first bin, so that NMS sees candidates and the boxes stay inside the image.
"""
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ld_tpu_torch import Config
from ld_tpu_torch.apis import init_detector
from ld_tpu_torch.ops import nms as nms_mod
from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
from ld_tpu_torch.tools.deployment import export, serve
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, 'configs/synthetic/gfl_r18_synthetic.py')


def synthetic_cfg(width=256):
    cfg = Config.fromfile(SYNTHETIC)
    cfg.dtype = 'float32'
    cfg.model.bbox_head.num_classes = 4
    cfg.model.neck.out_channels = width
    cfg.model.bbox_head.update(in_channels=width, feat_channels=width)
    return cfg


def write_checkpoint(cfg, path):
    """Seed-0 weights, `gfl_cls` bias 0 and a `gfl_reg` bias that puts each
    side's distribution near its first bin."""
    model = init_detector(cfg, device='cpu')
    head = model.bbox_head
    with torch.no_grad():
        head.gfl_cls.bias.zero_()
        head.gfl_reg.bias.view(4, head.reg_max + 1)[:, 1] = 3.0
    torch.save(dict(state_dict=model.state_dict()), path)
    return model


# ---- the operator -----------------------------------------------------------
def _candidates(seed, b=2, k=40):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (b, k, 2))], -1)
    valid = rng.uniform(size=(b, k)) < 0.9
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(valid))


def test_nms_keep_is_a_registered_operator():
    boxes, valid = _candidates(0)
    torch.library.opcheck(torch.ops.ld_tpu_torch.nms_keep.default,
                          (boxes, valid, 0.5))
    got = torch.ops.ld_tpu_torch.nms_keep(boxes, valid, 0.5)
    assert torch.equal(got, nms_keep_ref(boxes, valid, 0.5))
    assert torch.equal(nms_keep(boxes, valid, 0.5), got)
    assert got.data_ptr() != valid.data_ptr()
    # no box suppresses another: the plain version's output is still its own
    far = torch.arange(8.0).repeat_interleave(4).view(1, 8, 4) * 100
    far[..., 2:] += 10
    alone = torch.ones(1, 8, dtype=torch.bool)
    out = torch.ops.ld_tpu_torch.nms_keep(far, alone, 0.5)
    assert out.all() and out.data_ptr() != alone.data_ptr()


def test_default_keep_fn_reaches_the_operator():
    """`multiclass_nms` and `nms`, called without `keep_fn`, dispatch
    `ld_tpu_torch::nms_keep`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    boxes, _ = _candidates(1, b=2, k=30)
    scores = torch.from_numpy(np.random.RandomState(2).uniform(
        size=(2, 30, 3)).astype(np.float32))
    with Log() as log:
        nms_mod.multiclass_nms(boxes, scores, 0.05, 0.5, max_per_img=10)
        nms_mod.nms(boxes[0], scores[0, :, 0], 0.5, 10)
    assert log.ops.count('ld_tpu_torch.nms_keep.default') == 2


# ---- serving ----------------------------------------------------------------
SERVE_HW = (96, 128)


def _jpeg(seed, hw):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = (rng.randint(0, 64, hw + (3, ))).astype(np.uint8)
    for _ in range(3):
        y, x = rng.randint(0, hw[0] // 2), rng.randint(0, hw[1] // 2)
        img[y:y + hw[0] // 3, x:x + hw[1] // 3] = rng.randint(100, 256, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=90)
    return buf.getvalue()


def _post(port, data, path='/predict'):
    """(status, body, X-Batch header as (batch, slot, size))."""
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 method='POST')
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return (resp.status, json.loads(resp.read()),
                    tuple(map(int, resp.headers['X-Batch'].split())))
    except urllib.error.HTTPError as e:
        return e.code, None, None


@pytest.fixture(scope='module')
def server(tmp_path_factory):
    cfg = synthetic_cfg(width=64)
    ckpt = str(tmp_path_factory.mktemp('serve') / 'det.pth')
    write_checkpoint(cfg, ckpt)
    srv = serve.make_server(cfg, ckpt, input_size=SERVE_HW, max_batch=4,
                            score_thr=0.05, port=0, window_ms=50.0,
                            device='cpu')
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join()


def test_server_coalesces_concurrent_requests(server):
    port = server.server_address[1]
    sizes = [(120, 160), (96, 128), (80, 200), (150, 100), (64, 64),
             (100, 140)]
    images = [_jpeg(i, hw) for i, hw in enumerate(sizes)]
    replies = [None] * len(images)
    start = threading.Barrier(len(images))

    def client(i):
        start.wait()
        replies[i] = _post(port, images[i])
    threads = [threading.Thread(target=client, args=(i, ))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(status == 200 for status, _, _ in replies)
    formed = server.batcher.formed
    assert sum(formed) == len(images) and max(formed) > 1
    # the X-Batch headers name each batch's members, slots 0..n-1
    for index, count in enumerate(formed):
        members = sorted(r[2][1:] for r in replies if r[2][0] == index)
        assert [slot for slot, _ in members] == list(range(count))
        assert {size for _, size in members} == {
            next(s for s in (1, 2, 4) if s >= count)}
    for data, (_, body, _) in zip(images, replies):
        canvas, hw, scale = serve.preprocess(data, SERVE_HW)
        dets, labels, _ = server.infer(canvas[None],
                                       np.asarray([hw], np.float32))
        want = serve.detections(dets[0], labels[0], scale, 0.05)
        got = body['detections']
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g['label'] == w['label']
            np.testing.assert_allclose(g['bbox'] + [g['score']],
                                       w['bbox'] + [w['score']], atol=1e-4,
                                       rtol=0)


def test_server_404_and_device_error_500(server, monkeypatch):
    port = server.server_address[1]
    assert _post(port, _jpeg(9, (64, 64)), path='/other')[0] == 404

    def failing(images, img_hw):
        raise RuntimeError('device lost')
    monkeypatch.setattr(server.batcher, 'infer', failing)
    assert _post(port, _jpeg(9, (64, 64)))[0] == 500


# ---- export -----------------------------------------------------------------
EXPORT_HW = (64, 96)
CHILD = ("import json, runpy, sys; "
         "sys.argv = ['run_export.py', *sys.argv[1:]]; "
         "runpy.run_path({path!r}, run_name='__main__'); "
         "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
         "in ('jax', 'jaxlib', 'flax', 'ld_tpu', 'ld_tpu_torch'))))")


def test_export_keeps_nms_op_and_run_export_matches_eager(tmp_path):
    cfg = synthetic_cfg(width=64)
    model = write_checkpoint(cfg, str(tmp_path / 'det.pth')).eval()
    exported = export.export_detector(model, EXPORT_HW)
    assert len(export.nms_nodes(exported)) == 1
    inputs, outputs = export.io_specs(exported)
    assert [s[1] for s in inputs] == [(1, 3) + EXPORT_HW, (1, 2)]
    assert [s[1] for s in outputs] == [(1, 100, 5), (1, 100), (1, 100)]
    path = str(tmp_path / 'det.pt2')
    torch.export.save(exported, path)

    h, w = EXPORT_HW
    canvas = np.random.RandomState(0).randn(h, w, 3).astype(np.float32)
    batch = dict(image=torch.from_numpy(canvas).permute(2, 0, 1)[None]
                 .contiguous(), img_hw=torch.tensor([[float(h), float(w)]]))
    with torch.inference_mode():
        eager = model.forward_test(batch)
        loaded = torch.export.load(path).module()(batch['image'],
                                                  batch['img_hw'])
    for a, b in zip(loaded, eager):
        assert torch.equal(a, b)

    script = os.path.join(ROOT, 'ld_tpu_torch/tools/deployment/run_export.py')
    out = subprocess.run(
        [sys.executable, '-c', CHILD.format(path=script), path,
         '--score-thr', '0'], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr
    body, modules = out.stdout.rsplit('\n', 2)[:2]
    assert json.loads(modules) == ['ld_tpu_torch.ops.nms_cuda']
    got = json.loads(body)['detections']
    dets, labels, valid = (t[0].numpy() for t in eager)
    keep = valid & (dets[:, 4] > 0)
    assert len(got) == int(keep.sum()) > 0
    np.testing.assert_allclose([g['bbox'] + [g['score']] for g in got],
                               dets[keep], atol=1e-5, rtol=0)
    assert [g['label'] for g in got] == labels[keep].tolist()
