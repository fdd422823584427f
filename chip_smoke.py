"""Drive the ld_tpu_torch serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Phases, one JSON object per line each:
  1. device  — the card, torch/CUDA versions, TF32 switched off and printed;
  2. build   — nvcc builds ld_tpu_torch/csrc/nms_keep.cu for sm_90a;
  3. kernel  — the greedy-NMS kernel against its plain PyTorch version on the
               same CUDA tensors (bit-identical keep masks, and the keep mask
               fixed by construction where there is one) on the hand-made
               sets of ld_tpu_torch.testing at K in {1, 8, 63, 64, 65, 127,
               128, 512, 1000, 1024, 2048, 4100, 8192} and B in {1, 3, 8},
               and at K = 16800, B = 1; then, on the dense-kept and
               sparse-kept sets at (K, B) in {(512, 1), (1024, 1), (1024, 8)}:
               CUDA-event time per call over back-to-back calls, the host's
               time to issue them, each kernel's device time from
               torch.profiler, the kept count, the plain version's time and
               the bound the card could not beat;
  4. e2e     — GFL-R50 (configs/gfl/gfl_r50_fpn_1x_coco.py, full width,
               float32, random weights from seed 0, gfl_cls bias 0 so NMS
               sees 1024 valid candidates) answers seeded synthetic requests
               through `inference_detector` in both pad buckets, plus
               `forward_test` at 800x1344; the kernel's launch count over
               that run must equal the number of NMS batches, one request's
               post-processing is recomputed with the plain keep mask, and
               the head outputs on a small input must agree with the same
               model on the CPU;
  5. profile — device time of `forward_test` by kernel (torch.profiler);
  6. train   — the LD training step of configs/ld/ld_r50_gflv1_r101_fpn_coco_
               1x_gi.py at full width (R50 student from seed 0, R101 teacher
               from seed 1 with its BNs folded, loss_im weight 2 with gibox),
               float32, batch 2 at 800x1344 from ld_tpu_torch.testing, the
               config's SGD and schedule, through build_detector /
               build_lr_schedule / build_optimizer / make_train_step: 2
               warm-up and 5 timed steps, every loss finite after every step
               and 5 kernel launches per step (one GI NMS per FPN level);
               loss_im and the 5 GI masks of one step recomputed with the
               plain keep mask, identical; on 1x3x128x192 the first step's
               loss dict on the card within rtol 1e-3 of the same model on
               the CPU, term by term, with identical GI masks (and the
               smallest GI-score gap between picked and unpicked candidates);
               step and teacher-forward times, peak memory, and the device
               time of a step by kernel.
Then the `nvidia-smi` name/power-limit line, one JSON line of kernel figures
(the main path's case: dense-kept set, K = 1024, B = 1; `device_ms` is the
profiler's mask + sweep time; `launches` counts both main paths), and last
`{"ok": true, "device": {...}}`. Any failed check raises, so the script exits
non-zero and prints no result; so does a host without CUDA.
"""
import json
import math
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
TRAIN_CONFIG = 'configs/ld/ld_r50_gflv1_r101_fpn_coco_1x_gi.py'
# COCO train2017 images, for the schedule's steps per epoch on one card
COCO_TRAIN_IMAGES = 117266
ROOT = os.path.dirname(os.path.abspath(__file__))
# the two kernels of csrc/nms_keep.cu, as the profiler names them
NMS_KERNELS = ('nms_mask_tri_kernel', 'nms_block_sweep_kernel')
# the timed cases (K, B): K = 1024 is multiclass_nms's candidate count,
# K = 512 the GI path's
TIME_CASES = ((512, 1), (1024, 1), (1024, 8))


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def cuda_ms(fn, iters, warmup=3):
    """Mean time of `fn` over `iters` back-to-back calls, by CUDA events,
    and the host's mean time to issue one call; returns (event_ms,
    host_ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def kernel_device_ms(torch, fn, names, iters=50, tries=3):
    """Device time per launch of each kernel that `fn` launches once per
    call, from torch.profiler: {name: ms} for each of `names` (substrings
    of the profiler's kernel names). The profiler at times records only
    some of the launches of a session, or none: a session that does not
    show each kernel `iters` times is run again, and after `tries` such
    sessions the result is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [(n, e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                for n in names if n in e.key]
        if (len(seen) == len(names) and
                all(e.count == iters for _, e in seen)):
            return {n: e.self_device_time_total / iters / 1e3
                    for n, e in seen}
    return None


def nms_bound_ms(b, k):
    """Least time for the keep mask: IoU ops over the fp32 peak vs boxes,
    valid and keep bytes over the HBM rate; returns (ms, bound_by)."""
    ops = b * k * (k - 1) / 2 * IOU_OPS_PER_PAIR
    nbytes = b * k * (16 + 1 + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_kernel(torch):
    """Checks the kernel on the edge sets, then times it; returns the
    largest |kernel - plain| over the checks and the figures of the main
    path's case (dense-kept set, K = 1024, B = 1)."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.testing import NMS_CHECK_KB, NMS_SETS, nms_batch
    max_err = 0.0
    for name in NMS_SETS:
        kept = []
        for k, b in NMS_CHECK_KB:
            boxes, valid, fixed = nms_batch(name, b, k, seed=k)
            got = nms_keep(boxes, valid, 0.6)
            want = nms_keep_ref(boxes, valid, 0.6)
            torch.cuda.synchronize()
            max_err = max(max_err,
                          float((got.int() - want.int()).abs().max()))
            check(torch.equal(got, want), f'kernel keep mask differs '
                  f'from plain on {name} at B={b} K={k}')
            check(fixed is None or torch.equal(got.cpu(), fixed),
                  f'keep mask on {name} at B={b} K={k} is not the one '
                  f'the set fixes')
            kept.append(int(got.sum()))
            del boxes, valid, got, want
        emit(dict(phase='kernel_check', set=name, KB=NMS_CHECK_KB,
                  kept=kept, bit_identical=True))
    for name in ('dense_kept', 'sparse_kept'):
        for k, b in TIME_CASES:
            boxes, valid, _ = nms_batch(name, b, k, seed=7)
            row = dict(phase='kernel_time', set=name, K=k, B=b,
                       kept=int(nms_keep(boxes, valid, 0.6).sum()),
                       valid=int(valid.sum()))
            ms, host_ms = cuda_ms(lambda: nms_keep(boxes, valid, 0.6),
                                  iters=200)
            dev = kernel_device_ms(torch, lambda: nms_keep(boxes, valid, 0.6),
                                   NMS_KERNELS)
            plain, _ = cuda_ms(lambda: nms_keep_ref(boxes, valid, 0.6),
                               iters=20)
            bound, bound_by = nms_bound_ms(b, k)
            row.update(ms=ms, host_ms=host_ms,
                       device_ms=dev and sum(dev.values()),
                       **{f'device_ms_{n}': dev and dev[n]
                          for n in NMS_KERNELS},
                       plain_ms=plain, bound_ms=bound, bound_by=bound_by)
            emit(row)
            if (name, k, b) == ('dense_kept', 1024, 1):
                main_case = row
    return max_err, main_case


def phase_e2e(torch, np):
    from ld_tpu_torch.apis import inference_detector, init_detector
    from ld_tpu_torch.apis.inference import prepare_batch
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref

    torch.cuda.reset_peak_memory_stats()
    # what the earlier phases left allocated is part of the peak below
    allocated_at_start = torch.cuda.memory_allocated()
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
              memory_allocated_at_start_bytes=allocated_at_start,
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
                 if any(name in e.key for name in NMS_KERNELS))
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


def build_ld(torch):
    """The GI config's LD detector on the CPU: R50 student from seed 0, R101
    teacher from seed 1 with its BNs folded; returns (cfg, model)."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    cfg = Config.fromfile(os.path.join(ROOT, TRAIN_CONFIG))
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    check(model.fold_teacher_bn(), 'the teacher BN fold was refused')
    return cfg, model


def make_step(cfg, model):
    """The config's SGD and schedule around `model`, as make_train_step."""
    from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    spg = cfg.data['samples_per_gpu']
    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config,
                                 -(-COCO_TRAIN_IMAGES // spg),
                                 cfg.runner['max_epochs'])
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    return make_train_step(model, optimizer, scheduler,
                           (cfg.get('optimizer_config') or {}).get(
                               'grad_clip')), optimizer


def gi_score_gap(torch, head, outs, t_outs, masks):
    """Per level, the smallest |GI score| difference between a picked and an
    unpicked candidate: how far the scores are from reordering a pick."""
    from ld_tpu_torch.models.heads.gfl_head import flatten_levels
    z = (torch.sigmoid(flatten_levels(t_outs[0])) -
         torch.sigmoid(flatten_levels(outs[0])))
    score = z.abs().amax(dim=-1)                               # (B, N)
    gaps, lo = [], 0
    for mask in masks:
        n = mask.numel() // score.shape[0]
        s = score[:, lo:lo + n].reshape(-1)
        lo += n
        cand = torch.sort(s, descending=True, stable=True).indices[
            :min(head.gi_candidates, s.numel())]
        picked = mask[cand] > 0
        gaps.append(float((s[cand][picked][:, None] -
                           s[cand][~picked][None, :]).abs().min())
                    if picked.any() and (~picked).any() else None)
    return gaps


def phase_train_reference(torch, cfg, base):
    """The first step on 1x3x128x192 on the card against the same model on
    the CPU: the loss dict within rtol 1e-3, term by term, and the GI masks
    of that step identical."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    rtol = 1e-3
    runs = {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(base).to(device)
        batch = detection_batch(1, 128, 192, seed=0, device=device)
        step, _ = make_step(cfg, model)
        with torch.no_grad():
            outs = model(batch['image'])
            t_outs = model.teacher(batch['image'])
            masks = model.bbox_head.gi_masks(outs, t_outs)
            gaps = gi_score_gap(torch, model.bbox_head, outs, t_outs, masks)
        losses = step(batch)
        runs[device] = ({k: float(v) for k, v in losses.items()},
                        [m.cpu() for m in masks], gaps)
    (c_loss, c_masks, c_gaps), (g_loss, g_masks, _) = runs['cpu'], \
        runs['cuda']
    for k, c in c_loss.items():
        check(abs(g_loss[k] - c) <= rtol * abs(c),
              f'{k}: card {g_loss[k]!r} vs CPU {c!r} beyond rtol {rtol}')
    check(all(torch.equal(a, b) for a, b in zip(g_masks, c_masks)),
          'GI masks differ between the card and the CPU')
    emit(dict(phase='train_reference', input='1x3x128x192', rtol=rtol,
              loss_cpu=c_loss, loss_card=g_loss,
              max_rel_diff=max(abs(g_loss[k] - c) / abs(c)
                               for k, c in c_loss.items() if c),
              gi_masks_identical=True,
              gi_picks=[int(m.sum()) for m in c_masks],
              gi_candidates=[min(512, m.numel()) for m in c_masks],
              gi_min_score_gap_per_level=c_gaps))


def phase_train(torch, smi, warmup=2, timed=5, batch_size=2,
                pad=(800, 1344)):
    """The LD training step at full width on the card; returns the kernel's
    launch count over the main path's steps."""
    import copy
    from torch.profiler import ProfilerActivity, profile
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.testing import detection_batch

    t0 = time.perf_counter()
    cfg, base = build_ld(torch)
    check(cfg.data['samples_per_gpu'] == batch_size, 'samples_per_gpu')
    model = copy.deepcopy(base).to('cuda')
    step, optimizer = make_step(cfg, model)
    head = model.bbox_head
    check(head.loss_im.loss_weight == 2 and head.imitation_method == 'gibox',
          'the GI config lost its imitation arm')
    batch = detection_batch(batch_size, *pad, num_classes=80, seed=0,
                            device='cuda')
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    step_ms, lrs, history = [], [], []
    for i in range(warmup + timed):
        before = nms_keep.launches
        lrs.append(optimizer.param_groups[0]['lr'])
        t = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if i >= warmup:
            step_ms.append(ms)
        history.append({k: float(v) for k, v in metrics.items()})
        bad = [k for k, v in history[-1].items() if not math.isfinite(v)]
        check(not bad, f'step {i}: non-finite {bad}')
        check(nms_keep.launches - before == 5,
              f'step {i}: {nms_keep.launches - before} nms_keep launches, '
              'expected 5 (one GI NMS per FPN level)')
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    check(launches == 5 * (warmup + timed), f'{launches} launches')
    peak = torch.cuda.max_memory_allocated()

    # loss_im and the GI masks of one step, with the plain keep mask
    with torch.no_grad():
        outs, feats = model(batch['image'], output_features=True)
        t_outs, t_feats = model.teacher(batch['image'], output_features=True)
        sizes = [tuple(c.shape[-2:]) for c in outs[0]]
        got = head.gi_masks(outs, t_outs, keep_fn=nms_keep)
        want = head.gi_masks(outs, t_outs, keep_fn=nms_keep_ref)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              'GI masks with the kernel differ from the plain keep mask')
        im = [head.loss(outs, batch, sizes, t_outs, feats, t_feats,
                        keep_fn=fn)['loss_im'] for fn in (nms_keep,
                                                          nms_keep_ref)]
        check(torch.equal(im[0], im[1]),
              f'loss_im {float(im[0])} with the kernel, {float(im[1])} with '
              'the plain keep mask')
    gi_k = [min(head.gi_candidates, m.numel()) for m in got]

    # the teacher's forward alone
    with torch.no_grad():
        teacher_ms, _ = cuda_ms(lambda: model.teacher(batch['image'],
                                                      output_features=True),
                                iters=5, warmup=1)

    # device time of a step by kernel
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(prof_steps):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    nms_us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in NMS_KERNELS))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    profile_row = (dict(device_time='not measured') if total_us <= 0 else dict(
        device_ms_per_step=total_us / prof_steps / 1e3,
        wall_ms_per_step=wall_us / prof_steps / 1e3,
        device_busy_share=total_us / wall_us,
        device_ops_per_step=sum(e.count for e in kernels) / prof_steps,
        gi_nms_device_ms_per_step=nms_us / prof_steps / 1e3,
        top_kernels=[dict(name=e.key[:90], calls=e.count // prof_steps,
                          ms_per_step=e.self_device_time_total /
                          prof_steps / 1e3) for e in top]))

    emit(dict(phase='train', config=TRAIN_CONFIG, nvidia_smi=smi,
              dtype='float32 (the config dtype bfloat16 is not applied)',
              batch=[batch_size, 3, *pad],
              valid_gts=batch['gt_valid'].sum(dim=1).tolist(),
              params_student=sum(p.numel() for p in model.parameters()),
              params_trainable=sum(p.numel() for p in model.parameters()
                                   if p.requires_grad),
              params_teacher=sum(p.numel()
                                 for p in model.teacher.parameters()),
              build_s=build_s, warmup_steps=warmup, timed_steps=timed,
              step_ms=step_ms, step_ms_mean=sum(step_ms) / len(step_ms),
              step_ms_max=max(step_ms),
              img_per_s=batch_size * 1e3 * len(step_ms) / sum(step_ms),
              teacher_forward_ms=teacher_ms, lr=lrs,
              loss_first=history[0], loss_last=history[-1],
              nms_keep_launches=launches, nms_keep_launches_per_step=5,
              gi_candidates=gi_k, gi_picks=[int(m.sum()) for m in got],
              gi_plain_keep_identical=True,
              max_memory_allocated_bytes=peak, **profile_row))
    del model, step, optimizer, batch, prof
    torch.cuda.empty_cache()
    phase_train_reference(torch, cfg, base)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, ROOT)
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

    max_err, main_case = phase_kernel(torch)
    model, launches, bench = phase_e2e(torch, np)
    phase_profile(torch, model, bench)
    phase_reference(torch, np, model)
    del model, bench
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, smi)

    print(smi.splitlines()[0], flush=True)
    emit(dict(kernels=[dict(
        name='nms_keep', route='cuda', source='ld_tpu_torch/csrc/nms_keep.cu',
        replaces='ld_tpu/ops/pallas_nms.py:23',
        launches=launches + train_launches, launches_serve=launches,
        launches_train=train_launches,
        max_abs_err=max_err, ms=main_case['ms'],
        plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
        bound_by=main_case['bound_by'], library_ms=None,
        device_ms=main_case['device_ms'], host_ms=main_case['host_ms'],
        **{f'device_ms_{n}': main_case[f'device_ms_{n}']
           for n in NMS_KERNELS})]))
    emit(dict(ok=True, device=dict(platform='gpu',
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
