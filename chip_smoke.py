"""Drive the ld_tpu_torch serving path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Phases, one JSON object per line each:
  1. device  — the card, torch/CUDA versions, TF32 switched off and printed;
  2. build   — nvcc builds ld_tpu_torch/csrc/nms_keep.cu for sm_90a;
  3. kernel  — the greedy-NMS kernel against its plain PyTorch version on the
               same CUDA tensors (bit-identical keep masks) at K in
               {8, 512, 1000, 1024, 2048} and B in {1, 8}, then both timed
               with CUDA events at the main path's shape (K = 1024) and the
               bound the card could not beat;
  4. e2e     — GFL-R50 (configs/gfl/gfl_r50_fpn_1x_coco.py, full width,
               float32, random weights from seed 0, gfl_cls bias 0 so NMS
               sees 1024 valid candidates) answers seeded synthetic requests
               through `inference_detector` in both pad buckets, plus
               `forward_test` at 800x1344; the kernel's launch count over
               that run must equal the number of NMS batches, one request's
               post-processing is recomputed with the plain keep mask, and
               the head outputs on a small input must agree with the same
               model on the CPU;
  5. profile — device time of `forward_test` by kernel (torch.profiler).
Then the `nvidia-smi` name/power-limit line, one JSON line of kernel figures,
and last `{"ok": true, "device": {...}}`. Any failed check raises, so the
script exits non-zero and prints no result; so does a host without CUDA.
"""
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float ops per box pair in the IoU test: 4 min/max, 2 sub, 2 clamps, 1 mul,
# 1 add, 1 sub, 1 max, 1 div, 1 compare
IOU_OPS_PER_PAIR = 14
CONFIG = 'configs/gfl/gfl_r50_fpn_1x_coco.py'


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of `fn` over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_candidates(b, k, seed):
    """Score-sorted clustered boxes, class-offset as multiclass_nms builds
    them (80 classes, offset 4096), ~10% invalid, on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(b, max(k // 8, 1), 2, generator=g) * 1200
    pick = torch.randint(0, centers.shape[1], (b, k), generator=g)
    c = torch.gather(centers, 1, pick[..., None].expand(b, k, 2))
    c = c + torch.randn(b, k, 2, generator=g) * 8
    wh = torch.rand(b, k, 2, generator=g) * 150 + 10
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    cls = torch.randint(0, 80, (b, k), generator=g).float()
    boxes = boxes + (cls * 4096.0)[..., None]
    valid = torch.rand(b, k, generator=g) > 0.1
    return boxes.cuda().contiguous(), valid.cuda().contiguous()


def nms_bound_ms(b, k):
    """Least time for the keep mask: IoU ops over the fp32 peak vs boxes,
    valid and keep bytes over the HBM rate; returns (ms, bound_by)."""
    ops = b * k * (k - 1) / 2 * IOU_OPS_PER_PAIR
    nbytes = b * k * (16 + 1 + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_kernel(torch, nms_keep, nms_keep_ref):
    max_err = 0.0
    for k in (8, 512, 1000, 1024, 2048):
        for b in (1, 8):
            boxes, valid = nms_candidates(b, k, seed=k * 10 + b)
            got = nms_keep(boxes, valid, 0.6)
            want = nms_keep_ref(boxes, valid, 0.6)
            torch.cuda.synchronize()
            err = float((got.int() - want.int()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f'kernel keep mask differs from plain at B={b} K={k}')
            emit(dict(phase='kernel_check', B=b, K=k, kept=int(got.sum()),
                      valid=int(valid.sum()), bit_identical=True))
    timings = {}
    for b in (1, 8):
        boxes, valid = nms_candidates(b, 1024, seed=7)
        ms = cuda_ms(lambda: nms_keep(boxes, valid, 0.6), iters=200)
        plain = cuda_ms(lambda: nms_keep_ref(boxes, valid, 0.6), iters=20)
        bound, bound_by = nms_bound_ms(b, 1024)
        timings[b] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=bound_by)
        emit(dict(phase='kernel_time', B=b, K=1024, **timings[b]))
    return max_err, timings


def phase_e2e(torch, np):
    from ld_tpu_torch.apis import inference_detector, init_detector
    from ld_tpu_torch.apis.inference import prepare_batch
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_detector(CONFIG, device='cuda', seed=0)
    with torch.no_grad():
        model.bbox_head.gfl_cls.bias.zero_()
    torch.cuda.synchronize()
    emit(dict(phase='e2e_init', seconds=time.perf_counter() - t0,
              params=sum(p.numel() for p in model.parameters())))

    rng = np.random.RandomState(0)
    sizes = [(480, 640), (640, 480), (800, 1333), (600, 800), (800, 600),
             (427, 640), (1024, 768), (375, 500)]
    images = [rng.randint(0, 256, hw + (3, ), np.uint8) for hw in sizes]
    warm = [rng.randint(0, 256, hw + (3, ), np.uint8)
            for hw in ((480, 640), (640, 480))]
    bench = dict(image=torch.randn(1, 3, 800, 1344, device='cuda',
                                   generator=torch.Generator('cuda')
                                   .manual_seed(0)),
                 img_hw=torch.tensor([[800.0, 1344.0]], device='cuda'))

    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    batches = 0
    for img in warm:                  # first call per pad bucket
        inference_detector(model, img)
        batches += 1
    torch.cuda.synchronize()
    latencies, results = [], []
    t_all = time.perf_counter()
    for img in images:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
        batches += 1
    t_all = time.perf_counter() - t_all
    with torch.inference_mode():
        for _ in range(2):
            model.forward_test(bench)
            batches += 1
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            dets, labels, valid = model.forward_test(bench)
            batches += 1
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / iters
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    check(launches == batches,
          f'nms_keep launched {launches} times for {batches} NMS batches')
    peak = torch.cuda.max_memory_allocated()

    # where a request's time goes: the host pipeline alone (resize,
    # normalize, pad, copy to the card) on the same images
    host_ms = []
    for img in images:
        t0 = time.perf_counter()
        prepare_batch(img, 'cuda')
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    for hw, res in zip(sizes, results):
        boxes = res['boxes']
        check(boxes.ndim == 2 and boxes.shape[1] == 5 and
              0 < len(boxes) <= 100, f'result shape {boxes.shape} for {hw}')
        check(np.isfinite(boxes).all(), f'non-finite boxes for {hw}')
        # clipped to the resized image, then divided by the resize factor
        check((boxes[:, 2] <= hw[1] + 0.5).all() and
              (boxes[:, 3] <= hw[0] + 0.5).all() and
              (boxes[:, :4] >= 0).all(), f'boxes outside the image {hw}')
    check(tuple(dets.shape) == (1, 100, 5) and bool(torch.isfinite(dets).all())
          and int(valid.sum()) > 0, 'forward_test output at 800x1344')

    # one request's post-processing again, with the plain keep mask
    inputs = prepare_batch(images[2], 'cuda')
    with torch.inference_mode():
        outs = model(inputs['image'])
        args = (outs, inputs['img_hw'], inputs['scale_factor'])
        got = model.bbox_head.get_bboxes(*args, rescale=True)
        want = model.bbox_head.get_bboxes(*args, rescale=True,
                                          keep_fn=nms_keep_ref)
        _, scores = model.bbox_head.get_bboxes(*args, rescale=True,
                                               with_nms=False)
    n_cand = min(1024, int((scores > model.bbox_head.test_cfg['score_thr'])
                           .sum()))
    check(n_cand == 1024, f'{n_cand} valid NMS candidates, expected 1024')
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          'detections with the kernel differ from the plain keep mask')

    emit(dict(phase='e2e', config=CONFIG, requests=len(images),
              request_sizes=sizes, latency_ms=latencies,
              latency_ms_mean=sum(latencies) / len(latencies),
              latency_ms_max=max(latencies),
              host_pipeline_ms=host_ms,
              host_pipeline_ms_mean=sum(host_ms) / len(host_ms),
              img_per_s=len(images) / t_all,
              forward_test_800x1344_ms=fwd_ms,
              forward_test_img_per_s=1e3 / fwd_ms,
              nms_batches=batches, nms_keep_launches=launches,
              valid_nms_candidates=n_cand,
              detections_per_request=[len(r['boxes']) for r in results],
              max_memory_allocated_bytes=peak,
              plain_keep_identical=True))
    return model, launches, bench


def phase_profile(torch, model, bench, iters=3):
    """Device time of `forward_test` at 800x1344 by kernel, from
    torch.profiler: the share of the NMS kernel and of the rest, and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model.forward_test(bench)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model.forward_test(bench)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        emit(dict(phase='profile', device_time='not measured'))
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    nms_us = sum(e.self_device_time_total for e in kernels
                 if 'nms_mask_kernel' in e.key or 'nms_sweep_kernel' in e.key)
    emit(dict(phase='profile', what='forward_test 1x3x800x1344',
              iters=iters, device_ms_per_iter=total_us / iters / 1e3,
              wall_ms_per_iter=wall_us / iters / 1e3,
              device_busy_share=total_us / wall_us,
              nms_keep_ms_per_iter=nms_us / iters / 1e3,
              kernel_launches_per_iter=sum(e.count for e in kernels) / iters,
              top_kernels=[dict(name=e.key[:90], calls=e.count // iters,
                                ms_per_iter=e.self_device_time_total /
                                iters / 1e3) for e in top]))


def phase_reference(torch, np, model):
    """Head outputs on the card against the same model (same seed) on the
    CPU, small input, float32 on both (TF32 off): the bounds of the port's
    CPU tests against the JAX package."""
    from ld_tpu_torch.apis import init_detector
    cpu = init_detector(CONFIG, device='cpu', seed=0)
    with torch.no_grad():
        cpu.bbox_head.gfl_cls.bias.zero_()
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 128, 192)
                         .astype(np.float32))
    with torch.inference_mode():
        c_cls, c_reg = cpu(x)
        g_cls, g_reg = model(x.cuda())
    worst, worst_med = 0.0, 0.0
    for c, g in zip(c_cls + c_reg, g_cls + g_reg):
        diff = (g.cpu() - c).abs()
        worst = max(worst, float(diff.max()))
        worst_med = max(worst_med,
                        float((diff / (c.abs() + 1e-2)).median()))
    check(worst < 5e-3 and worst_med < 2e-4,
          f'card vs CPU head outputs: max {worst}, median rel {worst_med}')
    emit(dict(phase='reference', input='1x3x128x192', max_abs_diff=worst,
              max_median_rel_diff=worst_med, tol_abs=5e-3, tol_median_rel=2e-4))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ld_tpu_torch.ops import nms_cuda

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(dict(phase='device', name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), nvidia_smi=smi,
              python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_benchmark=torch.backends.cudnn.benchmark))

    t0 = time.perf_counter()
    lib = nms_cuda.build()
    emit(dict(phase='build', library=os.path.relpath(lib),
              seconds=time.perf_counter() - t0))

    max_err, timings = phase_kernel(torch, nms_cuda.nms_keep,
                                    nms_cuda.nms_keep_ref)
    model, launches, bench = phase_e2e(torch, np)
    phase_profile(torch, model, bench)
    phase_reference(torch, np, model)

    print(smi.splitlines()[0], flush=True)
    emit(dict(kernels=[dict(
        name='nms_keep', route='cuda', source='ld_tpu_torch/csrc/nms_keep.cu',
        replaces='ld_tpu/ops/pallas_nms.py:23', launches=launches,
        max_abs_err=max_err, ms=timings[1]['ms'],
        plain_ms=timings[1]['plain_ms'], bound_ms=timings[1]['bound_ms'],
        bound_by=timings[1]['bound_by'], library_ms=None)]))
    emit(dict(ok=True, device=dict(platform='gpu',
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
