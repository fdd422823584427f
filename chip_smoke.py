"""Drive the ld_tpu_torch serving, training, training-runtime and evaluation
paths, the other GFL-family heads, the configs' bf16 dtype, the DCN /
ResNeXt rows, the Res2Net-101-DCN teacher rows and data-parallel training
and evaluation on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Phases, one JSON object per line each:
  1. device  — the card, torch/CUDA versions, TF32 switched off and printed,
               and whether cv2 imports (only image files need it);
  2. build   — nvcc builds ld_tpu_torch/csrc/nms_keep.cu for sm_90a;
  3. kernel  — the greedy-NMS kernel against its plain PyTorch version on the
               same CUDA tensors (bit-identical keep masks, and the keep mask
               fixed by construction where there is one) on the hand-made
               sets of ld_tpu_torch.testing at K in {1, 8, 63, 64, 65, 127,
               128, 512, 1000, 1024, 2048, 4100, 8192} and B in {1, 3, 8},
               and at K = 16800, B = 1; then, on the dense-kept and
               sparse-kept sets at (K, B) in {(512, 1), (1024, 1), (1024, 8),
               (2048, 1)}:
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
               time of a step by kernel;
  7. runtime — `train_detector` on the same config over the data layer:
               its train pipeline without the two load steps (RandomFlip,
               FusedPreprocess, Collect) on 12 seeded synthetic 480x640
               images of 80 classes (the (800, 1088) pad bucket), 8 more
               for the eval hook, 2 epochs of 6 steps, save_best, a log line
               a step, the teacher from a seed-1 `.pth` through the strict
               `teacher_ckpt` path; once through, and once preempted by
               SIGTERM after step 3 and resumed. Every loss finite, 5 kernel
               launches a step plus 1 an eval batch, the resumed run's
               img_ids and LR per step equal to the first run's, one
               checkpoint kept and the best one written; then the step time
               in the loop against a bare `make_train_step` on the loader's
               batches, the loader's ms a batch, the device busy share of an
               epoch under the profiler, eval ms an image, checkpoint save
               ms and bytes, and peak memory;
  8. voc     — configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py at full width (R50
               student from the config's seed 0, R101 teacher from a seed-1
               `.pth`; the checkpoint tools/test.py reads has the trained
               student's gfl_cls bias set to 0) over a seeded synthetic
               VOC devkit (6 + 6 trainval images of VOC2007 and VOC2012, 8
               VOC2007 test images, at 500x375 and 375x500, 1-4 objects of
               the 20 classes, some difficult): `train_detector` over the
               config's own data (RepeatDataset x3, the unfused pipeline, the
               (608, 1024) / (1024, 608) buckets), one epoch and its eval at
               AP50:95, every loss finite; then tools/test.py on the
               checkpoint with `--eval mAP --out` (every image detected, the
               detections equal to eval_detector's) and with `--aug-test` at
               two scales and their flips (each image's TTA again, equal, and
               the first image's K = 2048 merge keep mask identical with the
               plain version); the kernel launched once an eval batch and
               once a TTA image, none a train step; the test split's gts
               score AP 1.0; then the TTA merge kernel's time, the AP50:95
               sweep's host time, the decode ms an image, the loader's ms a
               batch and the step time at (608, 1024).
  9. gfl_family — the other GFL-family heads at full width, float32, on
               seeded synthetic batches (ld_tpu_torch.testing) through
               build_detector / make_train_step / forward_test: the LDv2
               config configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py (R50
               GFocalV2 student from seed 0, R101 GFocalV2 teacher from
               seed 1 with its BNs folded, gibox imitation) for 2 + 5 steps
               at batch 2, 800x1344, 5 kernel launches a step, its GI masks
               and loss_im identical with the plain keep mask; the IMv2
               config for one step (loss_dfl 0, 5 launches); LD on ATSS-,
               FCOS- (caffe-style R101 teacher) and Retina-GFL
               (configs/ld/ld_r50_{atss,fcos}_r101_1x.py, ld_retina_r50_1x.py)
               for 2 + 3 steps each, no launch; every loss finite; the
               first step of each (but IMv2) at 1x3x128x192 on the card
               against the CPU, rtol 1e-3 a term (and identical GI masks);
               step, teacher and profile figures. Then forward_test at
               800x1344 of GFocalV2-R50, ATSS-GFL-R50, FCOS-GFL-R50 and
               Retina-GFL at R50 (cls prediction bias 0): 1 launch a call,
               the detections bit-identical with the plain keep mask, the
               first detection's score the largest class probability, and
               the NMS candidate count K.
 10. bf16, dcn, res2net — the configs' bf16 dtype; the DCN / ResNeXt
               rows; the imitation tables' Res2Net-101-DCN teacher rows:
               forward_test of configs/imv2/gflv2_r2n101_dcn_fpn_2x.py at
               800x1344 (1 launch a call, 90 DCN layers, their device
               share), the same model as a folded teacher at batch 2, its
               head outputs at 1x3x128x192 on the card against the CPU, and
               the three IMv2 configs that distil it at batch 2, 800x1344
               (5 launches a step; the R101 student's first step against
               the CPU, the self student in its bf16 dtype); the phase's
               launch count must equal RES2NET_LAUNCHES.
 11. ddp     — data parallelism over 2 ranks sharing the card (gloo; NCCL
               where there is a card a rank): (a) 4 steps of the GI config
               at full width, float32, batch 2 a rank at 800x1344 in 2
               spawned ranks against one process at batch 4 over the same
               images and weights (loss terms rtol 1e-3, GI masks
               identical, parameters after the step within 1e-5 of their
               largest value, 5 launches a step a rank); (b) this script
               in its worker mode under `python -m torch.distributed.run
               --nproc_per_node 2` on tools/train.py --launcher pytorch
               with the runtime phase's config, through, and preempted by
               a SIGTERM to rank 0 after step 3 and resumed (the same
               img_ids a rank, the same LR a step; rank 0 alone writes;
               5 launches a step a rank + 1 an eval batch); (c) the same
               on tools/test.py --launcher pytorch --eval bbox (every test
               image once, in dataset order, the detections those of a
               one-process forward_test of the same per-rank batches); (d)
               step ms against one process, the gradient all-reduce's ms,
               peak memory a rank, the phase's seconds: the collective
               path's cost on a shared card, not a scaling figure.
Then the `nvidia-smi` name/power-limit line, one JSON line of kernel figures
(the main path's case: dense-kept set, K = 1024, B = 1; `device_ms` is the
profiler's mask + sweep time; the `_k2048` keys the dense-kept set at
K = 2048, B = 1, the `_tta_merge` keys the first TTA image's own merge;
`launches` counts all main paths, `launches_<phase>` each), and last
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
# K = 512 the GI path's, K = 2048 the TTA merge's (one image)
TIME_CASES = ((512, 1), (1024, 1), (1024, 8), (2048, 1))
VOC_CONFIG = 'configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py'
# the synthetic devkit: 07+12 trainval and 07 test, at VOC's 500x375 and
# 375x500 in turn
VOC_SPLITS = {'VOC2007': {'trainval': 6, 'test': 8},
              'VOC2012': {'trainval': 6}}
# --aug-scales of the TTA run: two scales, each with its flip
TTA_SCALES = (1000, 600, 1333, 800)
# the gfl_family phase's LD configs (each with its R101 teacher): (config,
# nms_keep launches a step, warm-up steps, timed steps, card-vs-CPU check)
FAMILY_LD = (('configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py', 5, 2, 5, True),
             ('configs/imv2/im_r50_gflv2_r101_1x.py', 5, 0, 1, False),
             ('configs/ld/ld_r50_atss_r101_1x.py', 0, 2, 3, True),
             ('configs/ld/ld_r50_fcos_r101_1x.py', 0, 2, 3, True),
             ('configs/ld/ld_retina_r50_1x.py', 0, 2, 3, True))
# its serving configs: (config, backbone depth in place of the config's)
FAMILY_SERVE = (('configs/gfl/gflv2_r50_fpn_1x_coco.py', None),
                ('configs/gfl/atss_gfl_r50_1x.py', None),
                ('configs/gfl/fcos_gfl_r50_center.py', None),
                ('configs/gfl/retinagfl_r101_2x_coco.py', 50))
# the dcn phase: the DCN teachers served, one DCN layer of each stage shape
# (name, width, map at batch 2, conv groups), and the DCN LD configs (config,
# warm-up steps, timed steps)
DCN_SERVE = ('configs/gfl/gfl_r101_dcn_fpn_mstrain_2x_coco.py',
             'configs/gfl/gfl_x101_32x4d_fpn_dconv_c4-c5_mstrain_2x_coco.py')
DCN_LAYERS = (('r101_stage2', 128, (100, 168), 1),
              ('x101_stage3', 512, (50, 84), 32))
DCN_LD = (('configs/ld/ld_r101_gflv1_r101dcn_fpn_coco_2x.py', 2, 5),
          ('configs/ld/ld_x101_32x4d_dcn_self_2x_coco.py', 2, 3))
# the res2net phase: the GFLv2-Res2Net-101-DCN teacher served (warm-up and
# timed forward_test calls), its DCN layer count, and the IMv2 configs that
# distil it (config, warm-up steps, timed steps, student dtype, card vs CPU)
RES2NET_TEACHER = 'configs/imv2/gflv2_r2n101_dcn_fpn_2x.py'
RES2NET_SERVE_CALLS = (2, 10)
RES2NET_DCN_LAYERS = 90
RES2NET_IM = (('configs/imv2/im_r101_gflv2_r2n101_dcn_2x.py', 2, 5, None,
               True),
              ('configs/imv2/im_gflv2_r2n101_dcn_self-2x.py', 1, 3,
               'bfloat16', False),
              ('configs/imv2/im_gflv2_x101-32x4dr2n101_dcn_2x.py', 1, 2, None,
               False))
# its nms_keep launches, stated before the run: 1 a forward_test call, 5 a
# gibox step (one GI NMS per FPN level)
RES2NET_LAUNCHES = sum(RES2NET_SERVE_CALLS) + 5 * sum(
    w + t for _, w, t, _, _ in RES2NET_IM)


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


def nms_bound_ms(b, k, n_valid=None):
    """Least time for the keep mask: IoU ops over the fp32 peak vs boxes,
    valid and keep bytes over the HBM rate; returns (ms, bound_by). With
    `n_valid` (per image) only the pairs of valid boxes need their IoU."""
    n = k if n_valid is None else n_valid
    ops = b * n * (n - 1) / 2 * IOU_OPS_PER_PAIR
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
            if (name, k, b) == ('dense_kept', 2048, 1):
                tta_case = row
    return max_err, main_case, tta_case


def phase_e2e(torch, np):
    from ld_tpu_torch.apis import inference_detector, init_detector
    from ld_tpu_torch.apis.inference import prepare_batch
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref

    torch.cuda.reset_peak_memory_stats()
    # what the earlier phases left allocated is part of the peak below
    allocated_at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_detector(float32_cfg(CONFIG), device='cuda', seed=0)
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


def phase_profile(torch, model, bench, iters=3, phase='profile'):
    """Device time of `forward_test` at 800x1344 by kernel, from
    torch.profiler: the share of the NMS kernel and of the rest, and the
    device's busy share of the wall time; returns the emitted row."""
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
        row = dict(phase=phase, device_time='not measured')
        emit(row)
        return row
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    nms_us = sum(e.self_device_time_total for e in kernels
                 if any(name in e.key for name in NMS_KERNELS))
    row = dict(phase=phase, what='forward_test 1x3x800x1344',
               iters=iters, device_ms_per_iter=total_us / iters / 1e3,
               wall_ms_per_iter=wall_us / iters / 1e3,
               device_busy_share=total_us / wall_us,
               nms_keep_ms_per_iter=nms_us / iters / 1e3,
               kernel_launches_per_iter=sum(e.count for e in kernels) / iters,
               top_kernels=[dict(name=e.key[:90], calls=e.count // iters,
                                 ms_per_iter=e.self_device_time_total /
                                 iters / 1e3) for e in top])
    emit(row)
    return row


def head_output_diff(cpu_outs, card_outs):
    """The largest max-abs and median-relative differences over every
    level of every head output, card against CPU."""
    worst, worst_med = 0.0, 0.0
    for c_part, g_part in zip(cpu_outs, card_outs):
        for c, g in zip(c_part, g_part):
            diff = (g.cpu() - c).abs()
            worst = max(worst, float(diff.max()))
            worst_med = max(worst_med,
                            float((diff / (c.abs() + 1e-2)).median()))
    return worst, worst_med


def phase_reference(torch, np, model):
    """Head outputs on the card against the same model (same seed) on the
    CPU, small input, float32 on both (TF32 off): the bounds of the port's
    CPU tests against the JAX package."""
    from ld_tpu_torch.apis import init_detector
    cpu = init_detector(float32_cfg(CONFIG), device='cpu', seed=0)
    with torch.no_grad():
        cpu.bbox_head.gfl_cls.bias.zero_()
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 128, 192)
                         .astype(np.float32))
    with torch.inference_mode():
        worst, worst_med = head_output_diff(cpu(x), model(x.cuda()))
    check(worst < 5e-3 and worst_med < 2e-4,
          f'card vs CPU head outputs: max {worst}, median rel {worst_med}')
    emit(dict(phase='reference', input='1x3x128x192', max_abs_diff=worst,
              max_median_rel_diff=worst_med, tol_abs=5e-3, tol_median_rel=2e-4))


def float32_cfg(config):
    """A config file with its compute dtype pinned to float32, so that the
    float32 phases' figures and bounds stay comparable across versions."""
    from ld_tpu_torch import Config
    cfg = Config.fromfile(os.path.join(ROOT, config))
    cfg.dtype = 'float32'
    return cfg


def build_ld(torch, config=TRAIN_CONFIG, dtype=None, student_offsets=True):
    """An LD config's detector on the CPU, its towers in `dtype` (None:
    float32; its teacher, named by a config path, stays float32): the
    student from seed 0 (its DCN offsets seeded too, or, without
    `student_offsets`, left at the init's zero), the teacher from seed 1
    (DCN offsets too) with its BNs folded; returns (cfg, model)."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import randomize_dcn_offsets
    cfg = Config.fromfile(os.path.join(ROOT, config))
    model = build_detector(cfg.model, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    if student_offsets:
        randomize_dcn_offsets(model, seed=0)
    randomize_dcn_offsets(model.teacher, seed=1)
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
    cls, soft_label, _, _ = head.gi_levels(outs, t_outs)
    z = head.gi_scores(flatten_levels(cls), flatten_levels(soft_label))
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


# card vs CPU at 1x3x128x192 on the same weights: float32 (TF32 off) holds
# the losses to rtol 1e-3 and the GI masks identical; bfloat16 towers hold
# the head outputs to the JAX package's own bf16 bound (tests/test_bf16.py)
# and the losses to rtol 2e-2, and the GI masks that differ are counted
REFERENCE_TOL = {None: dict(rtol=1e-3, head_atol=None, exact_gi=True),
                 'bfloat16': dict(rtol=2e-2, head_atol=0.15, exact_gi=False)}


def phase_train_reference(torch, cfg, base, gi=True,
                          phase='train_reference', dtype=None):
    """The first step on 1x3x128x192 on the card against the same model on
    the CPU, within the tolerances of `REFERENCE_TOL[dtype]`: the loss dict
    term by term, with bf16 towers the head outputs too, and (with `gi`)
    the GI masks of that step, identical in float32."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    tol = REFERENCE_TOL[dtype]
    rtol = tol['rtol']
    runs = {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(base).to(device)
        batch = detection_batch(1, 128, 192, seed=0, device=device)
        step, _ = make_step(cfg, model)
        masks, gaps, heads = [], [], []
        with torch.no_grad():
            outs = model(batch['image'])
            heads = [x.cpu() for part in outs for x in part]
            if gi:
                t_outs = model.teacher(batch['image'])
                masks = model.bbox_head.gi_masks(outs, t_outs)
                gaps = gi_score_gap(torch, model.bbox_head, outs, t_outs,
                                    masks)
        losses = step(batch)
        runs[device] = ({k: float(v) for k, v in losses.items()},
                        [m.cpu() for m in masks], gaps, heads)
        del model, step
    (c_loss, c_masks, c_gaps, c_heads), (g_loss, g_masks, _, g_heads) = \
        runs['cpu'], runs['cuda']
    head_diff = max(float((a - b).abs().max())
                    for a, b in zip(c_heads, g_heads))
    rel = {k: abs(g_loss[k] - c) / abs(c) for k, c in c_loss.items() if c}
    row = dict(phase=phase, config=os.path.relpath(cfg.filename, ROOT),
               input='1x3x128x192', dtype=dtype or 'float32',
               rtol=rtol, loss_cpu=c_loss, loss_card=g_loss,
               max_rel_diff=max(rel.values()), rel_diff=rel,
               head_max_abs_diff=head_diff, head_atol=tol['head_atol'])
    n_differ = sum(int((a != b).sum()) for a, b in zip(g_masks, c_masks))
    if gi:
        row.update(gi_masks_differing=n_differ,
                   gi_picks=[int(m.sum()) for m in c_masks],
                   gi_candidates=[min(512, m.numel()) for m in c_masks],
                   gi_min_score_gap_per_level=c_gaps)
    emit(row)
    for k, c in c_loss.items():
        check(abs(g_loss[k] - c) <= rtol * abs(c),
              f'{k}: card {g_loss[k]!r} vs CPU {c!r} beyond rtol {rtol}')
    check(tol['head_atol'] is None or head_diff <= tol['head_atol'],
          f'card vs CPU head outputs differ by {head_diff}, beyond '
          f'{tol["head_atol"]}')
    check(not tol['exact_gi'] or n_differ == 0,
          'GI masks differ between the card and the CPU')


def phase_train(torch, smi, warmup=2, timed=5, batch_size=2,
                pad=(800, 1344)):
    """The GI config's LD training step at full width on the card; returns
    the kernel's launch count over the main path's steps."""
    return ld_steps(torch, smi, TRAIN_CONFIG, 5, warmup, timed,
                    batch_size=batch_size, pad=pad, phase='train')[0]


def ld_steps(torch, smi, config, per_step, warmup, timed, reference=True,
             batch_size=2, pad=(800, 1344), phase='gfl_family', dtype=None,
             cpu_check=True, student_offsets=True, prof_steps=2):
    """An LD config's training step at full width on the card: the student
    from seed 0, its towers in `dtype` (None: float32), the teacher from
    seed 1 with its BNs folded, the config's SGD and schedule, `warmup` +
    `timed` steps on a batch of `batch_size` at `pad`; every loss finite
    and `per_step` nms_keep launches a step. With GI (`per_step` 5), the
    GI NMS's K of each level, and the GI masks and loss_im of one step
    recomputed with the plain keep mask, identical. With `dtype`: every
    parameter and gradient float32 after the steps, the student's FPN
    features in `dtype` and the path teacher's float32. With `reference`:
    the teacher's forward time, the device time of a step by kernel, then,
    with `cpu_check`, the first step at 1x3x128x192 on the card against the
    CPU; `prof_steps` steps are profiled. `student_offsets` goes to
    `build_ld`. Returns the launch count of the steps and the emitted
    row."""
    import copy
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.testing import detection_batch

    t0 = time.perf_counter()
    cfg, base = build_ld(torch, config, dtype, student_offsets)
    check(cfg.data['samples_per_gpu'] == batch_size, 'samples_per_gpu')
    model = copy.deepcopy(base).to('cuda')
    step, optimizer = make_step(cfg, model)
    head = model.bbox_head
    gi = per_step > 0
    check(gi == (getattr(head, 'imitation_method', None) == 'gibox' and
                 head.loss_im.loss_weight > 0), f'{config}: GI arm')
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
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        bad = [k for k, v in history[-1].items() if not math.isfinite(v)]
        check(not bad, f'{config} step {i}: non-finite {bad}')
        check(nms_keep.launches - before == per_step,
              f'{config} step {i}: {nms_keep.launches - before} nms_keep '
              f'launches, expected {per_step}')
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               dtype=dtype or 'float32', head=type(head).__name__,
               teacher_head=type(model.teacher.bbox_head).__name__,
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
               lr=lrs, loss_first=history[0], loss_last=history[-1],
               nms_keep_launches=launches,
               nms_keep_launches_per_step=per_step,
               max_memory_allocated_bytes=peak,
               dcn_layers_student=count_dcn(model),
               dcn_layers_teacher=count_dcn(model.teacher))
    if dtype:
        params = list(model.parameters())
        check({p.dtype for p in params} == {torch.float32} and
              {p.grad.dtype for p in params if p.grad is not None} ==
              {torch.float32}, f'{config}: a parameter or gradient is not '
              'float32')
        with torch.no_grad():
            _, feats = model(batch['image'], output_features=True)
            _, t_feats = model.teacher(batch['image'], output_features=True)
        want = getattr(torch, dtype)
        check({f.dtype for f in feats} == {want} and
              {f.dtype for f in t_feats} == {torch.float32},
              f'{config}: FPN features {feats[0].dtype}, teacher\'s '
              f'{t_feats[0].dtype}')
        row.update(params_and_grads_float32=True,
                   fpn_dtype=str(feats[0].dtype),
                   teacher_fpn_dtype=str(t_feats[0].dtype))
        del feats, t_feats
    if gi:
        gi_k = []

        def capture(boxes, valid, thr):
            gi_k.append(boxes.shape[1])
            return nms_keep(boxes, valid, thr)
        with torch.no_grad():
            outs, feats = model(batch['image'], output_features=True)
            t_outs, t_feats = model.teacher(batch['image'],
                                            output_features=True)
            sizes = [tuple(c.shape[-2:]) for c in outs[0]]
            got = head.gi_masks(outs, t_outs, keep_fn=capture)
            want = head.gi_masks(outs, t_outs, keep_fn=nms_keep_ref)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f'{config}: GI masks with the kernel differ from the '
                  'plain keep mask')
            im = [head.loss(outs, batch, sizes, t_outs, feats, t_feats,
                            keep_fn=fn)['loss_im'] for fn in (nms_keep,
                                                              nms_keep_ref)]
            check(torch.equal(im[0], im[1]),
                  f'{config}: loss_im {float(im[0])} with the kernel, '
                  f'{float(im[1])} with the plain keep mask')
        want_k = [min(head.gi_candidates, m.numel()) for m in got]
        check(gi_k == want_k, f'{config}: GI NMS at K = {gi_k}, expected '
              f'{want_k}')
        row.update(gi_candidates=gi_k, gi_picks=[int(m.sum()) for m in got],
                   gi_plain_keep_identical=True)
        del outs, feats, t_outs, t_feats
    if reference:
        with torch.no_grad():
            row['teacher_forward_ms'], _ = cuda_ms(
                lambda: model.teacher(batch['image'], output_features=True),
                iters=5, warmup=1)
        row.update(step_profile(torch, step, batch, prof_steps))
    emit(row)
    del model, step, optimizer, batch
    torch.cuda.empty_cache()
    if reference and cpu_check:
        phase_train_reference(torch, cfg, base, gi=gi,
                              phase=f'{phase}_reference', dtype=dtype)
    return launches, row


def count_dcn(module):
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    return sum(isinstance(m, ModulatedDeformConv2d) for m in module.modules())


def step_profile(torch, step, batch, prof_steps=2, top_n=10):
    """Device time of `prof_steps` steps by kernel, from torch.profiler:
    device ms a step against its wall ms (the busy share), device ops a
    step, the GI NMS kernels' ms a step and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
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
    if total_us <= 0:
        return dict(device_time='not measured')
    nms_us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in NMS_KERNELS))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    return dict(
        device_ms_per_step=total_us / prof_steps / 1e3,
        wall_ms_per_step=wall_us / prof_steps / 1e3,
        device_busy_share=total_us / wall_us,
        device_ops_per_step=sum(e.count for e in kernels) / prof_steps,
        gi_nms_device_ms_per_step=nms_us / prof_steps / 1e3,
        top_kernels=[dict(name=e.key[:90], calls=e.count // prof_steps,
                          ms_per_step=e.self_device_time_total /
                          prof_steps / 1e3) for e in top])


def runtime_cfg(teacher_path):
    """The GI config for the runtime phase: its train pipeline without the
    two load steps (RandomFlip, FusedPreprocess, Collect) over 12 seeded
    synthetic 480x640 images of 80 classes, 8 more for validation with its
    test pipeline, its six pad buckets, 2 epochs, an eval with save_best
    each epoch, a log line each step, one checkpoint kept, and the teacher
    from `teacher_path`."""
    from ld_tpu_torch import Config
    cfg = Config.fromfile(os.path.join(ROOT, TRAIN_CONFIG))
    loads = ('LoadImageFromFile', 'LoadAnnotations')
    train_pipe = [dict(t) for t in cfg.train_pipeline if t['type'] not in loads]
    test_pipe = [dict(t) for t in cfg.test_pipeline if t['type'] not in loads]
    check([t['type'] for t in train_pipe] ==
          ['RandomFlip', 'FusedPreprocess', 'Collect'] and
          len(cfg.pad_to) == 6, 'the GI config\'s train pipeline or buckets')
    synth = dict(type='SyntheticDetectionDataset', hw=(480, 640),
                 num_classes=80, draw_boxes=True)
    cfg.data = dict(cfg.data, train=dict(synth, num_images=12, seed=0,
                                         pipeline=train_pipe),
                    val=dict(synth, num_images=8, seed=1, pipeline=test_pipe))
    cfg.runner = dict(type='EpochBasedRunner', max_epochs=2)
    cfg.evaluation = dict(interval=1, metric='bbox', save_best='bbox_mAP')
    cfg.log_config = dict(cfg.log_config, interval=1)
    cfg.checkpoint_config = dict(interval=1, max_keep_ckpts=1)
    cfg.model.teacher_ckpt = teacher_path
    cfg.dtype = 'float32'
    return cfg


def instrument_steps(train_api, record, preempt_after=None):
    """Wrap the make_train_step that train_detector calls: each step's
    img_ids, loss dict and nms_keep launches go to `record`, and after the
    `preempt_after`-th step of this run SIGTERM is raised in the main
    thread, as a preempting scheduler would send it."""
    import signal
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.parallel import make_train_step
    calls = []

    def wrapped(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def run(batch):
            before = nms_keep.launches
            out = step(batch)
            record.append(dict(img_ids=batch['img_ids'].tolist(),
                               launches=nms_keep.launches - before,
                               losses={k: float(v) for k, v in out.items()}))
            calls.append(1)
            if len(calls) == preempt_after:
                signal.raise_signal(signal.SIGTERM)
            return out
        return run
    train_api.make_train_step = wrapped


def read_log(work_dir):
    with open(os.path.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


def phase_runtime(torch, smi, steps_per_epoch=6, epochs=2, eval_batches=2):
    """train_detector on the card at full width over the data layer, twice:
    once through, and once preempted by SIGTERM after step 3 and resumed;
    returns the kernel's launch count over the two runs."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    import ld_tpu_torch.apis.train as train_api
    from ld_tpu_torch.apis import eval_detector, train_detector
    from ld_tpu_torch.data import (DevicePrefetcher, build_dataloader,
                                   build_dataset)
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.parallel import make_train_step
    from ld_tpu_torch.utils.checkpoint import save_checkpoint
    from ld_tpu_torch import Config

    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_runtime')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # the teacher's .pth, from seed 1, so that the strict teacher_ckpt path
    # runs
    teacher_path = os.path.join(work, 'teacher_r101_seed1.pth')
    cfg = runtime_cfg(teacher_path)
    teacher = build_detector(Config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config)).model)
    teacher.init_weights(torch.Generator().manual_seed(1))
    torch.save(dict(state_dict=teacher.state_dict()), teacher_path)
    del teacher
    steps = steps_per_epoch * epochs
    want_launches = 5 * steps + eval_batches * epochs
    make_step = train_api.make_train_step
    runs = {}
    try:
        for name in ('through', 'preempted'):
            wd = os.path.join(work, name)
            record = []
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            # ---- the main path: counts from 0, read right after ----------
            nms_keep.launches = 0
            if name == 'through':
                instrument_steps(train_api, record)
                ret = train_detector(runtime_cfg(teacher_path), wd)
                check(not ret['preempted'] and ret['step'] == steps,
                      f'{name}: {ret["step"]} steps')
            else:
                instrument_steps(train_api, record, preempt_after=3)
                first = train_detector(runtime_cfg(teacher_path), wd)
                check(first['preempted'] and first['step'] == 3,
                      f'preempted at step {first["step"]}, not 3')
                ckpts_at_preemption = sorted(os.listdir(
                    os.path.join(wd, 'checkpoints')))
                del first
                resume = runtime_cfg(teacher_path)
                resume.resume_from = wd
                instrument_steps(train_api, record)
                ret = train_detector(resume, wd)
                check(not ret['preempted'] and ret['step'] == steps,
                      f'resumed run ended at step {ret["step"]}')
            launches = nms_keep.launches
            # --------------------------------------------------------------
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            log = read_log(wd)
            runs[name] = dict(ret=ret if name == 'preempted' else None,
                              record=record, log=log, wd=wd,
                              launches=launches, seconds=seconds, peak=peak)
            check(len(record) == steps, f'{name}: {len(record)} steps')
            bad = [(i, k) for i, r in enumerate(record)
                   for k, v in r['losses'].items() if not math.isfinite(v)]
            check(not bad, f'{name}: non-finite losses {bad[:5]}')
            check(all(r['launches'] == 5 for r in record),
                  f'{name}: nms_keep launches per step '
                  f'{[r["launches"] for r in record]}, expected 5')
            check(launches == want_launches,
                  f'{name}: {launches} nms_keep launches, expected '
                  f'{want_launches} (5 a step, 1 an eval batch)')
            check(sorted(os.listdir(os.path.join(wd, 'checkpoints'))) ==
                  [f'{steps}.pth'], f'{name}: checkpoints not pruned')
            check(os.path.exists(os.path.join(wd, 'best_bbox_mAP.pth')),
                  f'{name}: no best_bbox_mAP.pth')
            check(len([x for x in log if x['mode'] == 'val']) == epochs,
                  f'{name}: {epochs} val lines expected')
            del ret
    finally:
        train_api.make_train_step = make_step

    through, pre = runs['through'], runs['preempted']
    lr = {n: [x['lr'] for x in r['log'] if x['mode'] == 'train']
          for n, r in runs.items()}
    check([r['img_ids'] for r in pre['record']] ==
          [r['img_ids'] for r in through['record']],
          'the resumed run\'s img_ids per step differ from the first run\'s')
    check(lr['preempted'] == lr['through'] and len(lr['through']) == steps,
          'the resumed run\'s LR per step differs from the first run\'s')
    check(ckpts_at_preemption == ['3.pth'],
          f'checkpoints at preemption: {ckpts_at_preemption}')

    # where the time goes, on the resumed run's model and optimizer
    model, optimizer = pre['ret']['model'], pre['ret']['optimizer']
    scheduler = pre['ret']['scheduler']
    train_ds = build_dataset(cfg.data['train'])
    loader = build_dataloader(train_ds, cfg.data['samples_per_gpu'], 1,
                              cfg.pad_to, 100, seed=0)
    list(loader)                                   # warm the native build
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    prefetcher = DevicePrefetcher(loader, 'cuda')
    batches = list(prefetcher)
    bucket = list(batches[0]['image'].shape)
    step = make_train_step(model, optimizer, scheduler)
    step(batches[0])
    torch.cuda.synchronize()
    bare_ms = []
    for b in batches[1:]:
        t = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t) * 1e3)
    del batches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        n = 0
        for b in prefetcher:
            step(b)
            n += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    val_ds = build_dataset(cfg.data['val'])
    eval_detector(model, val_ds, pad_hw=cfg.pad_to)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eval_detector(model, val_ds, pad_hw=cfg.pad_to)
    eval_ms_per_image = (time.perf_counter() - t) * 1e3 / len(val_ds)
    t = time.perf_counter()
    path = save_checkpoint(os.path.join(work, 'timing'), model, optimizer,
                           scheduler, steps)
    save_ms = (time.perf_counter() - t) * 1e3
    save_bytes = os.path.getsize(path)

    # in-loop step time: log.json's per-step wall time, without the first
    # step of each epoch (which also holds the previous epoch's checkpoint
    # and eval, or the warm-up)
    train_lines = [x for x in through['log'] if x['mode'] == 'train']
    in_loop = [x['time'] * 1e3 for x in train_lines
               if (x['iter'] - 1) % steps_per_epoch]
    epoch_first = [x['time'] * 1e3 for x in train_lines
                   if (x['iter'] - 1) % steps_per_epoch == 0]
    emit(dict(phase='runtime', config=TRAIN_CONFIG, nvidia_smi=smi,
              data='SyntheticDetectionDataset 12 train + 8 val, 480x640, '
                   '80 classes, draw_boxes',
              pipeline=[t['type'] for t in cfg.data['train']['pipeline']],
              batch=bucket, steps=steps, epochs=epochs,
              seconds_through=through['seconds'],
              seconds_preempted_and_resumed=pre['seconds'],
              nms_keep_launches=through['launches'],
              nms_keep_launches_preempted_and_resumed=pre['launches'],
              nms_keep_launches_expected=want_launches,
              checkpoints_at_preemption=ckpts_at_preemption,
              resumed_img_ids_equal=True, resumed_lr_equal=True,
              lr=lr['through'],
              loss_first=through['record'][0]['losses'],
              loss_last=through['record'][-1]['losses'],
              val=[{k: None if isinstance(v, float) and math.isnan(v)
                    else v for k, v in x.items()}
                   for x in through['log'] if x['mode'] == 'val'],
              step_ms_in_loop=in_loop,
              step_ms_in_loop_mean=sum(in_loop) / len(in_loop),
              step_ms_first_of_epoch=epoch_first,
              step_ms_bare=bare_ms,
              step_ms_bare_mean=sum(bare_ms) / len(bare_ms),
              loader_ms_per_batch=loader_ms,
              loader_workers=loader.num_workers,
              profiled_steps=n,
              device_busy_share=(device_us / wall_us if device_us > 0
                                 else 'not measured'),
              device_ms_per_step=(device_us / n / 1e3 if device_us > 0
                                  else 'not measured'),
              wall_ms_per_step_profiled=wall_us / n / 1e3,
              eval_ms_per_image=eval_ms_per_image,
              checkpoint_save_ms=save_ms, checkpoint_bytes=save_bytes,
              max_memory_allocated_bytes=through['peak']))
    del model, optimizer, scheduler, pre, runs, prefetcher, prof, step, b
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return through['launches'] + want_launches


def load_tool(name):
    """A script of ld_tpu_torch/tools (run as a file, not a package module)
    as a module, so that its `main(argv)` runs in this process."""
    import importlib.util
    path = os.path.join(ROOT, 'ld_tpu_torch', 'tools', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'tool_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def voc_cfg(devkit, teacher_path):
    """The VOC LD config over the devkit at `devkit`: its own data
    (RepeatDataset x3 of 07+12 trainval with the unfused pipeline, its pad
    buckets, 07 test), one epoch and its eval hook at AP50:95, a log line a
    step, one checkpoint kept, and the teacher from `teacher_path`."""
    from ld_tpu_torch import Config
    cfg = Config.fromfile(os.path.join(ROOT, VOC_CONFIG))
    for d in (cfg.data.train.dataset, cfg.data.val, cfg.data.test):
        for key in ('ann_file', 'img_prefix'):
            v = d[key]
            d[key] = [x.replace('data/VOCdevkit/', devkit + '/') for x in v] \
                if isinstance(v, list) else v.replace('data/VOCdevkit/',
                                                      devkit + '/')
    cfg.runner = dict(type='EpochBasedRunner', max_epochs=1)
    cfg.log_config = dict(cfg.log_config, interval=1)
    cfg.checkpoint_config = dict(interval=1, max_keep_ckpts=1)
    cfg.model.teacher_ckpt = teacher_path
    cfg.dtype = 'float32'
    return cfg


def same_results(np, a, b):
    """Two lists of per-image detections, bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(x['boxes'], y['boxes']) and
        np.array_equal(x['labels'], y['labels']) for x, y in zip(a, b))


def phase_voc(torch, np, smi):
    """The evaluation entry point and the paper's VOC path at full width:
    train_detector over the VOC config's own data, then tools/test.py on
    its checkpoint (--eval mAP --out, then --aug-test); returns the kernel's
    launch count over the three runs and the TTA merge's keep-mask figures
    at K = 2048, B = 1."""
    import shutil
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import (eval_detector, init_detector,
                                   train_detector)
    from ld_tpu_torch.apis.aug_test import aug_test, build_aug_views
    from ld_tpu_torch.data import (DevicePrefetcher, LoadImageFromFile,
                                   build_dataloader, build_dataset)
    from ld_tpu_torch.data.transforms import _cv2
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.parallel import make_train_step
    from ld_tpu_torch.testing import write_voc_devkit
    from ld_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                               read_state_dict)

    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_voc')
    shutil.rmtree(work, ignore_errors=True)
    devkit = os.path.join(work, 'VOCdevkit')
    t0 = time.perf_counter()
    write_voc_devkit(devkit, VOC_SPLITS, seed=0)
    # the R101 teacher from seed 1, in a .pth, so that the strict
    # teacher_ckpt path runs
    teacher_path = os.path.join(work, 'teacher_r101_seed1.pth')
    cfg = voc_cfg(devkit, teacher_path)
    teacher = build_detector(Config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config)).model)
    teacher.init_weights(torch.Generator().manual_seed(1))
    torch.save(dict(state_dict=teacher.state_dict()), teacher_path)
    del teacher
    cfg_path = os.path.join(work, 'ld_r50_voc_smoke.py')
    cfg.dump(cfg_path)
    cfg = Config.fromfile(cfg_path)
    train_ds = build_dataset(cfg.data['train'])
    test_ds = build_dataset(cfg.data['test'])
    check(type(train_ds).__name__ == 'RepeatDataset' and train_ds.times == 3
          and len(train_ds.dataset) == 12 and
          train_ds.dataset.ids[-1].startswith('2008_') and len(test_ds) == 8,
          'the VOC config\'s data over the synthetic devkit')
    check([t['type'] for t in cfg.data['train']['dataset']['pipeline']] ==
          ['LoadImageFromFile', 'LoadAnnotations', 'Resize', 'RandomFlip',
           'Normalize', 'Pad', 'Collect'], 'the VOC train pipeline')
    # eval_detector's batches (4 images, one aspect group each)
    eval_batches = len(build_dataloader(test_ds, 4, 1, cfg.pad_to, max_gts=1,
                                        shuffle=False))
    setup_s = time.perf_counter() - t0

    # ---- the main path: counts from 0, read right after ------------------
    wd = os.path.join(work, 'train')
    nms_keep.launches = 0
    t0 = time.perf_counter()
    ret = train_detector(Config.fromfile(cfg_path), wd)
    train_s = time.perf_counter() - t0
    train_launches = nms_keep.launches
    # ----------------------------------------------------------------------
    log = read_log(wd)
    train_lines = [x for x in log if x['mode'] == 'train']
    val_lines = [x for x in log if x['mode'] == 'val']
    check(not ret['diverged'] and not ret['preempted'] and
          ret['step'] == ret['steps_per_epoch'] == len(train_lines),
          f'{ret["step"]} steps, {len(train_lines)} log lines')
    bad = [(x['iter'], k) for x in train_lines for k, v in x.items()
           if k.startswith('loss') and not math.isfinite(v)]
    check(not bad, f'non-finite losses {bad[:5]}')
    check(len(val_lines) == 1 and all(f'AP{t}' in val_lines[0]
                                       for t in range(50, 100, 5)),
          f'the eval hook\'s AP50:95 line: {val_lines}')
    check(train_launches == eval_batches,
          f'{train_launches} nms_keep launches in training, expected '
          f'{eval_batches} (none a step, 1 an eval batch)')
    # the trained student with its gfl_cls bias set to 0, as in the e2e
    # phase, so that the barely trained model clears score_thr everywhere
    state = read_state_dict(latest_checkpoint(wd))
    state['bbox_head.gfl_cls.bias'].zero_()
    ckpt = os.path.join(work, 'student_trained_cls_bias0.pth')
    torch.save(dict(state_dict=state), ckpt)

    tool = load_tool('test')
    out_json = os.path.join(work, 'metrics.json')
    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    t0 = time.perf_counter()
    cli = tool.main([cfg_path, ckpt, '--eval', 'mAP', '--out', out_json])
    cli_s = time.perf_counter() - t0
    cli_launches = nms_keep.launches
    # ----------------------------------------------------------------------
    nms_keep.launches = 0
    t0 = time.perf_counter()
    tta = tool.main([cfg_path, ckpt, '--eval', 'AP50:95', '--aug-test',
                     '--aug-scales', *map(str, TTA_SCALES)])
    tta_s = time.perf_counter() - t0
    tta_launches = nms_keep.launches
    # ----------------------------------------------------------------------
    check(cli_launches == eval_batches,
          f'tools/test.py launched nms_keep {cli_launches} times for '
          f'{eval_batches} eval batches')
    check(tta_launches == len(test_ds),
          f'tools/test.py --aug-test launched nms_keep {tta_launches} times '
          f'for {len(test_ds)} images')
    with open(out_json) as f:
        check(json.load(f) == cli['metrics'], '--out differs from the print')
    for name, res in (('--eval', cli['results']),
                      ('--aug-test', tta['results'])):
        check(len(res) == len(test_ds) and
              all(0 < len(r['boxes']) <= 100 and np.isfinite(r['boxes']).all()
                  for r in res), f'{name}: an image without detections')

    # the same checkpoint through eval_detector: the same detections
    model = init_detector(cfg_path, ckpt)
    want = eval_detector(model, test_ds, pad_hw=cfg.pad_to)
    check(same_results(np, cli['results'], want),
          'tools/test.py detections differ from eval_detector\'s')
    t0 = time.perf_counter()
    eval_detector(model, test_ds, pad_hw=cfg.pad_to)
    eval_img_per_s = len(test_ds) / (time.perf_counter() - t0)

    # TTA of each image again, timed; the first image's K = 2048 merge
    # keep mask recomputed with the plain version
    norm = [t for t in cfg.data['test']['pipeline']
            if t['type'] == 'Normalize'][0]
    norm = dict(mean=norm['mean'], std=norm['std'], to_rgb=norm['to_rgb'])
    scales = [TTA_SCALES[i:i + 2] for i in range(0, len(TTA_SCALES), 2)]
    captured = []

    def capture(boxes, valid, thr):
        keep = nms_keep(boxes, valid, thr)
        captured.append((boxes, valid, thr, keep))
        return keep
    tta_ms = []
    for i, info in enumerate(test_ds.img_infos):
        img = _cv2().imread(os.path.join(test_ds.id_prefixes[i],
                                         info['filename']))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aug_test(model, build_aug_views(img, scales, flip=True, **norm),
                       img.shape[:2], keep_fn=capture)
        tta_ms.append((time.perf_counter() - t0) * 1e3)
        check(same_results(np, [res], [tta['results'][i]]),
              f'image {i}: aug_test differs from tools/test.py --aug-test')
    boxes, valid, thr, keep = captured[0]
    check(tuple(boxes.shape) == (1, 2048, 4), f'TTA merge K {boxes.shape}')
    check(torch.equal(keep, nms_keep_ref(boxes, valid, thr)),
          'the TTA merge keep mask differs from the plain version')
    merge_ms, merge_host_ms = cuda_ms(lambda: nms_keep(boxes, valid, thr),
                                      iters=200)
    merge_dev = kernel_device_ms(torch, lambda: nms_keep(boxes, valid, thr),
                                 NMS_KERNELS)
    merge_plain, _ = cuda_ms(lambda: nms_keep_ref(boxes, valid, thr),
                             iters=20)
    merge_bound, merge_bound_by = nms_bound_ms(1, 2048, int(valid.sum()))
    merge = dict(K=2048, B=1, valid=int(valid.sum()), kept=int(keep.sum()),
                 ms=merge_ms, host_ms=merge_host_ms,
                 device_ms=merge_dev and sum(merge_dev.values()),
                 plain_ms=merge_plain, bound_ms=merge_bound,
                 bound_by=merge_bound_by)

    # the evaluator: the test split's own gts score 1 at every threshold;
    # then the AP50:95 sweep of the detections, timed
    gts = [[np.concatenate([a['bboxes'][a['labels'] == c],
                            np.ones((int((a['labels'] == c).sum()), 1))], 1)
            for c in range(len(test_ds.CLASSES))]
           for a in test_ds.annotations]
    check(test_ds.evaluate(gts, metric='mAP')['mAP'] == 1.0 and
          all(v == 1.0 for v in test_ds.evaluate(gts, 'AP50:95').values()),
          'gt-derived detections do not score AP 1.0')
    t0 = time.perf_counter()
    sweep = test_ds.evaluate(cli['results'], metric='AP50:95')
    eval_map_ms = (time.perf_counter() - t0) * 1e3

    # where a step's time goes: the decode, the loader, and bare steps of
    # the trained model on the batches of the first (landscape) bucket
    prefix = train_ds.dataset.id_prefixes
    decode_ms = []
    for i, info in enumerate(train_ds.dataset.img_infos):
        t0 = time.perf_counter()
        LoadImageFromFile()(dict(img_info=info, img_prefix=prefix[i]))
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    loader = build_dataloader(train_ds, cfg.data['samples_per_gpu'], 1,
                              cfg.pad_to, cfg.max_gts_per_image, seed=0)
    list(loader)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    bucket = tuple(cfg.pad_to[0])
    batches = [b for b in DevicePrefetcher(loader, 'cuda')
               if tuple(b['image'].shape[-2:]) == bucket]
    step = make_train_step(ret['model'], ret['optimizer'], ret['scheduler'],
                           (cfg.get('optimizer_config') or {}).get(
                               'grad_clip'))
    step(batches[0])
    torch.cuda.synchronize()
    step_ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    emit(dict(phase='voc', config=VOC_CONFIG, nvidia_smi=smi,
              data='synthetic VOC devkit: 07 trainval 6 + 12 trainval 6 '
                   '(RepeatDataset x3), 07 test 8; 500x375 and 375x500',
              setup_s=setup_s, train_s=train_s, steps=ret['step'],
              loss_first=train_lines[0], loss_last=train_lines[-1],
              val=val_lines[0], cli_eval_s=cli_s,
              cli_eval_img_per_s=len(test_ds) / cli_s,
              eval_detector_img_per_s=eval_img_per_s,
              cli_metrics=cli['metrics'], cli_tta_s=tta_s,
              tta_metrics=tta['metrics'], tta_scales=scales,
              tta_ms_per_image=tta_ms,
              tta_ms_per_image_mean=sum(tta_ms) / len(tta_ms),
              detections_per_image=[len(r['boxes']) for r in cli['results']],
              tta_detections_per_image=[len(r['boxes'])
                                        for r in tta['results']],
              eval_batches=eval_batches,
              nms_keep_launches_train=train_launches,
              nms_keep_launches_cli=cli_launches,
              nms_keep_launches_tta=tta_launches,
              tta_merge_keep_plain_identical=True, tta_merge=merge,
              gt_ap50=1.0, eval_map_ap50_95_ms=eval_map_ms,
              eval_map_ap50_95=sweep['mAP'],
              decode_ms_per_image=sum(decode_ms) / len(decode_ms),
              loader_ms_per_batch=loader_ms,
              step_bucket=bucket, step_ms=step_ms,
              step_ms_mean=sum(step_ms) / len(step_ms)))
    del model, ret, step, batches
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return train_launches + cli_launches + tta_launches, merge


def top_score(torch, head, outs):
    """The largest class probability over every anchor and class of one
    image, computed apart from the decode: the first detection's score,
    since the best candidate always survives the top-k and the NMS."""
    name = type(head).__name__
    if name == 'GFocalHead':
        probs = outs[0]
    elif name in ('ATSSGFLHead', 'FCOSGFLHead'):
        probs = [torch.sigmoid(c) * torch.sigmoid(r)
                 for c, r in zip(outs[0], outs[2])]
    else:
        probs = [torch.sigmoid(c) for c in outs[0]]
    return max(float(p.max()) for p in probs)


def family_serve(torch, smi, config, depth=None, warmup=2, timed=10,
                 hw=(800, 1344), phase='gfl_family_serve', extra=None):
    """`forward_test` of a GFL-family config at 800x1344, batch 1, at full
    width (random weights from seed 0, DCN offsets too, the cls prediction
    bias 0 so that NMS sees candidates); 1 nms_keep launch a call, the
    detections bit-identical with the plain keep mask, and the first
    detection's score the largest class probability (no second sigmoid on
    probabilities). `extra(model, bench)` adds figures to the row. Returns
    the launch count and the emitted row."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.testing import randomize_dcn_offsets

    cfg = Config.fromfile(os.path.join(ROOT, config))
    if depth is not None:
        cfg.model.backbone.depth = depth
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    dcn_layers = randomize_dcn_offsets(model, seed=0)
    head = model.bbox_head
    with torch.no_grad():
        getattr(head, head.cls_pred_name).bias.zero_()
    model = model.to('cuda').eval()
    bench = dict(image=torch.randn(1, 3, *hw, device='cuda',
                                   generator=torch.Generator('cuda')
                                   .manual_seed(0)),
                 img_hw=torch.tensor([hw], dtype=torch.float32,
                                     device='cuda'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        for _ in range(warmup):
            model.forward_test(bench)
        torch.cuda.synchronize()
        call_ms = []
        for _ in range(timed):
            t = time.perf_counter()
            dets, _, valid = model.forward_test(bench)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t) * 1e3)
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        check(launches == warmup + timed,
              f'{config}: nms_keep launched {launches} times for '
              f'{warmup + timed} forward_test calls')
        check(tuple(dets.shape) == (1, 100, 5) and
              bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0,
              f'{config}: forward_test output at {hw}')
        outs = model(bench['image'])
        captured = []

        def capture(boxes, valid, thr):
            captured.append((tuple(boxes.shape), int(valid.sum())))
            return nms_keep(boxes, valid, thr)
        got = head.get_bboxes(outs, bench['img_hw'], keep_fn=capture)
        want = head.get_bboxes(outs, bench['img_hw'], keep_fn=nms_keep_ref)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f'{config}: detections with the kernel differ from the plain '
              'keep mask')
        dets, valid = got[0], got[2]
        best = top_score(torch, head, outs)
        check(abs(float(dets[0, 0, 4]) - best) <= 1e-6,
              f'{config}: first detection score {float(dets[0, 0, 4])} is '
              f'not the largest class probability {best}')
    (_, k, _), n_valid = captured[0]
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               depth=cfg.model.backbone.depth, head=type(head).__name__,
               backbone=type(model.backbone).__name__, dcn_layers=dcn_layers,
               input=[1, 3, *hw], warmup_calls=warmup, timed_calls=timed,
               forward_test_ms=call_ms,
               forward_test_ms_mean=sum(call_ms) / len(call_ms),
               forward_test_ms_max=max(call_ms),
               max_memory_allocated_bytes=peak,
               nms_keep_launches=launches, nms_keep_launches_per_call=1,
               nms_k=k, nms_valid_candidates=n_valid,
               detections=int(valid.sum()),
               top_score=float(dets[0, 0, 4]), plain_keep_identical=True)
    if extra is not None:
        with torch.no_grad():
            row.update(extra(model, bench))
    emit(row)
    del model, outs, bench
    torch.cuda.empty_cache()
    return launches, row


def phase_gfl_family(torch, smi):
    """The other GFL-family heads at full width: LDv2 (2 + 5 steps), IMv2
    (1 step), LD on ATSS-, FCOS- and Retina-GFL (2 + 3 steps each), then
    `forward_test` of a GFocalV2, ATSS-, FCOS- and Retina-GFL R50; returns
    the kernel's launch count over their main paths."""
    launches = 0
    for config, per_step, warmup, timed, reference in FAMILY_LD:
        n, row = ld_steps(torch, smi, config, per_step, warmup, timed,
                          reference)
        if 'imv2' in config:
            check(row['loss_first']['loss_dfl'] == 0.0,
                  f'{config}: loss_dfl {row["loss_first"]["loss_dfl"]}')
        launches += n
    for config, depth in FAMILY_SERVE:
        launches += family_serve(torch, smi, config, depth)[0]
    return launches


def match_share(torch, ref, alt, iou=0.9):
    """The share of `ref`'s valid detections (dets, labels, valid of one
    image) that some valid detection of `alt` of the same class overlaps
    at IoU > `iou`."""
    from ld_tpu_torch.ops.boxes import bbox_overlaps
    (rd, rl, rv), (ad, al, av) = [(d[0], lab[0], v[0]) for d, lab, v in
                                  (ref, alt)]
    rd, rl, ad, al = rd[rv], rl[rv], ad[av], al[av]
    if len(rd) == 0:
        return None
    hit = (bbox_overlaps(rd[:, :4], ad[:, :4]) > iou) & \
        (rl[:, None] == al[None, :])
    return float(hit.any(dim=1).float().mean())


def bf16_serve(torch, smi, warmup=2, timed=10, hw=(800, 1344)):
    """`forward_test` of GFL-R50 in the config's own dtype (bfloat16
    towers) at 800x1344, batch 1, beside the same model in float32 in the
    same call: 1 nms_keep launch a call at K = 1024, the detections
    identical with the plain keep mask, float32 outputs from bf16 backbone
    and FPN outputs, the first detection's score the largest class
    probability, and the share of the float32 detections the bf16 ones
    match. Returns the launch count and the emitted row."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref

    cfg = Config.fromfile(os.path.join(ROOT, CONFIG))
    check(cfg.dtype == 'bfloat16', f'{CONFIG} dtype {cfg.dtype}')
    model = init_detector(cfg, device='cuda', seed=0)
    plain = init_detector(float32_cfg(CONFIG), device='cuda', seed=0)
    for m in (model, plain):
        with torch.no_grad():
            m.bbox_head.gfl_cls.bias.zero_()
    bench = dict(image=torch.randn(1, 3, *hw, device='cuda',
                                   generator=torch.Generator('cuda')
                                   .manual_seed(0)),
                 img_hw=torch.tensor([hw], dtype=torch.float32,
                                     device='cuda'))
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, {t.dtype for t in out})
        return hook
    hooks = [mod.register_forward_hook(record(name))
             for name, mod in (('backbone', model.backbone),
                               ('neck', model.neck))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        for _ in range(warmup):
            model.forward_test(bench)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(timed):
            dets, labels, valid = model.forward_test(bench)
        torch.cuda.synchronize()
        bf16_ms = (time.perf_counter() - t) * 1e3 / timed
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        for h in hooks:
            h.remove()
        check(launches == warmup + timed,
              f'bf16 serving: nms_keep launched {launches} times for '
              f'{warmup + timed} forward_test calls')
        for _ in range(warmup):
            plain.forward_test(bench)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(timed):
            ref = plain.forward_test(bench)
        torch.cuda.synchronize()
        fp32_ms = (time.perf_counter() - t) * 1e3 / timed

        outs = model(bench['image'])
        captured = []

        def capture(boxes, valid, thr):
            captured.append(boxes.shape[1])
            return nms_keep(boxes, valid, thr)
        head = model.bbox_head
        got = head.get_bboxes(outs, bench['img_hw'], keep_fn=capture)
        want = head.get_bboxes(outs, bench['img_hw'], keep_fn=nms_keep_ref)
        best = top_score(torch, head, outs)
    check(seen == {'backbone': {torch.bfloat16}, 'neck': {torch.bfloat16}},
          f'bf16 serving: backbone / FPN output dtypes {seen}')
    check({x.dtype for part in outs for x in part} == {torch.float32} and
          dets.dtype == torch.float32, 'bf16 serving: outputs not float32')
    check(captured == [1024], f'bf16 serving: NMS at K = {captured}')
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          'bf16 serving: detections with the kernel differ from the plain '
          'keep mask')
    check(tuple(dets.shape) == (1, 100, 5) and
          bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0,
          f'bf16 serving: forward_test output at {hw}')
    check(abs(float(got[0][0, 0, 4]) - best) <= 1e-6,
          f'bf16 serving: first detection score {float(got[0][0, 0, 4])} '
          f'is not the largest class probability {best}')
    prof = phase_profile(torch, model, bench, phase='bf16_profile')
    row = dict(phase='bf16_serve', config=CONFIG, nvidia_smi=smi,
               dtype=cfg.dtype, input=[1, 3, *hw],
               warmup_calls=warmup, timed_calls=timed,
               forward_test_ms=bf16_ms, forward_test_ms_float32=fp32_ms,
               max_memory_allocated_bytes=peak,
               device_ops_per_call=prof.get('kernel_launches_per_iter'),
               nms_keep_launches=launches, nms_k=captured[0],
               detections=int(valid.sum()),
               top_score=float(dets[0, 0, 4]),
               float32_dets_matched_iou_0_9=match_share(torch, ref,
                                                        (dets, labels,
                                                         valid)),
               backbone_fpn_dtype='bfloat16', outputs_dtype='float32',
               plain_keep_identical=True)
    emit(row)
    del model, plain, outs, bench
    torch.cuda.empty_cache()
    return launches, row


def phase_bf16(torch, smi):
    """The configs' own compute dtype (bfloat16 towers, float32 parameters,
    a path teacher in float32) at full width: GFL-R50 serving, the GI
    config's LD step (2 + 5 steps, 5 launches a step, against the CPU at
    1x3x128x192), then one step of LDv2, LD-ATSS, LD-FCOS and LD-Retina
    after one warm-up; returns the kernel's launch count over their main
    paths."""
    launches = bf16_serve(torch, smi)[0]
    launches += ld_steps(torch, smi, TRAIN_CONFIG, 5, 2, 5, phase='bf16_train',
                         dtype='bfloat16')[0]
    for config, per_step, _, _, _ in FAMILY_LD:
        if 'imv2' in config:
            continue
        launches += ld_steps(torch, smi, config, per_step, 1, 1,
                             reference=False, phase='bf16_family',
                             dtype='bfloat16')[0]
    return launches


def dcn_device_share(torch, model, fn, iters=3):
    """Device time of `fn` (one forward_test call or teacher forward) and
    of the DCN layers inside it, from torch.profiler: each
    ModulatedDeformConv2d's forward runs in a `record_function` range, and
    its `conv_offset` conv in one of its own, whose device time is that of
    the kernels they launch. Also the HBM bound of those layers' gathers.
    Returns a dict of per-call figures (the DCN time 'not measured' when
    the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    ranges, cols = [], []

    def enter(name):
        def hook(module, args):
            ranges.append(record_function(name))
            ranges[-1].__enter__()
        return hook

    def leave(module, args, out):
        ranges.pop().__exit__(None, None, None)
        if isinstance(module, ModulatedDeformConv2d):
            b, _, oh, ow = out.shape
            cols.append(b * oh * ow * 9 * module.in_channels)
    dcns = [m for m in model.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    hooks = [h for m, name in [(m, 'dcn_layer') for m in dcns] +
             [(m.conv_offset, 'dcn_offset_conv') for m in dcns]
             for h in (m.register_forward_pre_hook(enter(name)),
                       m.register_forward_hook(leave))]
    try:
        fn()
        torch.cuda.synchronize()
        calls = len(cols)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for h in hooks:
            h.remove()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda and
               e.key not in ('dcn_layer', 'dcn_offset_conv')]
    total_us = sum(e.self_device_time_total for e in kernels)

    def range_ms(name):
        us = sum(e.device_time_total for e in events
                 if e.key == name and e.device_type != cuda)
        return us / iters / 1e3 if us > 0 else 'not measured'
    # four corner reads and the columns' write, float32, a layer
    bound_ms = sum(5 * 4 * n for n in cols[:calls]) / PEAK_HBM_BYTES * 1e3
    out = dict(dcn_layers_called=calls, dcn_gather_bound_ms=bound_ms,
               dcn_columns_bytes=4 * sum(cols[:calls]))
    if total_us <= 0:
        out['device_time'] = 'not measured'
        return out
    dcn_ms = range_ms('dcn_layer')
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out.update(device_ms_per_call=total_us / iters / 1e3,
               wall_ms_per_call_profiled=wall_us / iters / 1e3,
               device_busy_share=total_us / wall_us,
               device_ops_per_call=sum(e.count for e in kernels) / iters,
               dcn_device_ms_per_call=dcn_ms,
               dcn_offset_conv_device_ms_per_call=range_ms('dcn_offset_conv'),
               dcn_device_share=(dcn_ms / (total_us / iters / 1e3)
                                 if dcn_ms != 'not measured' else dcn_ms),
               top_kernels=[dict(name=e.key[:90], calls=e.count // iters,
                                 ms_per_call=e.self_device_time_total /
                                 iters / 1e3) for e in top])
    return out


def teacher_forward(torch, model, batch_size=2, hw=(800, 1344), iters=3):
    """The served DCN model as an LD config's teacher runs it: BNs folded,
    no grad, float32, a batch of 2 at 800x1344; its forward ms and its DCN
    layers' share of the device time over `iters` profiled calls."""
    from ld_tpu_torch.testing import detection_batch
    from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    fuse_conv_bn(model)
    image = detection_batch(batch_size, *hw, seed=0, device='cuda')['image']
    with torch.no_grad():
        ms, _ = cuda_ms(lambda: model(image, output_features=True), iters=5,
                        warmup=1)
        share = dcn_device_share(
            torch, model, lambda: model(image, output_features=True), iters)
    return dict(teacher_forward_ms=ms, teacher_input=[batch_size, 3, *hw],
                **{f'teacher_{k}': v for k, v in share.items()})


def voting_serve(torch, model, bench, warmup=2, timed=5):
    """The R101-DCN model's `forward_test` with test_cfg.nms.type
    'voting_cluster_diounms': no nms_keep launch; its dets on the card
    against the CPU on the same candidates (labels and valid identical,
    boxes and scores within 1e-4 relative); its ms a call and the
    fixpoint's rounds (the stop test syncs with the host once a round)."""
    from ld_tpu_torch.ops.nms import multiclass_nms_voting
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    head = model.bbox_head
    plain_nms = head.test_cfg['nms']
    head.test_cfg['nms'] = dict(type='voting_cluster_diounms',
                                iou_threshold=plain_nms['iou_threshold'])
    try:
        with torch.inference_mode():
            # ---- the main path: counts from 0, read right after ----------
            nms_keep.launches = 0
            for _ in range(warmup):
                model.forward_test(bench)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(timed):
                dets, labels, valid = model.forward_test(bench)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t) * 1e3 / timed
            launches = nms_keep.launches
            # --------------------------------------------------------------
            rounds = multiclass_nms_voting.iterations
            boxes, scores = head.get_bboxes(model(bench['image']),
                                            bench['img_hw'], with_nms=False)
            cfg = head.test_cfg
            args = (cfg['score_thr'], cfg['nms']['iou_threshold'],
                    cfg['max_per_img'])
            t = time.perf_counter()
            got = multiclass_nms_voting(boxes, scores, *args)
            torch.cuda.synchronize()
            nms_ms = (time.perf_counter() - t) * 1e3
            want = multiclass_nms_voting(boxes.cpu(), scores.cpu(), *args)
    finally:
        head.test_cfg['nms'] = plain_nms
    check(launches == 0, f'voting forward_test launched nms_keep '
          f'{launches} times')
    check(tuple(dets.shape) == (1, 100, 5) and int(valid.sum()) > 0 and
          bool(torch.isfinite(dets).all()), 'voting forward_test output')
    g_dets, g_labels, g_valid = (t.cpu() for t in got)
    check(torch.equal(g_labels, want[1]) and torch.equal(g_valid, want[2]),
          'voting NMS labels or valid flags differ between card and CPU')
    rel = float(((g_dets - want[0]).abs() /
                 want[0].abs().clamp(min=1.0)).max())
    check(rel <= 1e-4, f'voting NMS dets differ by {rel} relative between '
          'card and CPU')
    return dict(voting_forward_test_ms=call_ms, voting_nms_ms=nms_ms,
                voting_nms_keep_launches=launches,
                voting_fixpoint_rounds=rounds,
                voting_detections=int(valid.sum()),
                voting_card_vs_cpu_max_rel=rel)


def dcn_layer_check(torch, name, c, hw, groups, batch=2):
    """One DCN layer at a full-width stage shape, with seeded weights and
    non-zero offsets: on the card against the CPU on the same weights and
    input (max abs <= 1e-4 x max |out|); with zero offsets and mask logits
    of 30 equal to F.conv2d of its weight; its device ms against the HBM
    bound of its gathers."""
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    from ld_tpu_torch.testing import randomize_dcn_offsets
    layer = ModulatedDeformConv2d(c, c, 3, 1, groups=groups)
    layer.init_weights(torch.Generator().manual_seed(0))
    randomize_dcn_offsets(layer, seed=0)
    x = torch.randn(batch, c, *hw, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = layer(x)
        layer = layer.cuda()
        xc = x.cuda()
        got = layer(xc).cpu()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-4 * scale, f'DCN {name}: card vs CPU max abs {err}, '
              f'bound {1e-4 * scale}')
        ms, host_ms = cuda_ms(lambda: layer(xc), iters=10, warmup=2)
        dev = dcn_device_share(torch, layer, lambda: layer(xc))
        conv_ms, _ = cuda_ms(lambda: torch.nn.functional.conv2d(
            xc, layer.weight, padding=1, groups=groups), iters=10, warmup=2)
        layer.conv_offset.weight.zero_()
        layer.conv_offset.bias.zero_()
        layer.conv_offset.bias[-9:] = 30.0
        zero = layer(xc)
        plain = torch.nn.functional.conv2d(xc, layer.weight, padding=1,
                                           groups=groups)
        zero_err = float((zero - plain).abs().max())
        check(zero_err <= 1e-4 * float(plain.abs().max()),
              f'DCN {name}: zero offsets differ from F.conv2d by {zero_err}')
    row = dict(layer=name, input=[batch, c, *hw], groups=groups,
               max_abs_err=err, max_abs_out=scale, ms=ms, host_ms=host_ms,
               device_ms=dev.get('dcn_device_ms_per_call', 'not measured'),
               offset_conv_device_ms=dev.get(
                   'dcn_offset_conv_device_ms_per_call', 'not measured'),
               conv2d_ms=conv_ms, zero_offset_conv2d_max_abs=zero_err,
               gather_bound_ms=dev['dcn_gather_bound_ms'],
               columns_bytes=dev['dcn_columns_bytes'])
    del layer, x, xc
    torch.cuda.empty_cache()
    return row


def phase_dcn(torch, smi):
    """The paper's DCN-teacher and ResNeXt rows at full width: forward_test
    of GFL-R101-DCN and GFL-X101-32x4d-DCN (1 launch a call, plain-keep
    identical dets, the DCN layers' share of device time; the R101-DCN
    model with the voting NMS; each model then as its LD config's teacher
    runs it); one DCN layer of each stage shape on the card against the
    CPU; 2 + 5 steps of the R101-DCN -> R101 LD config and 2 + 3 of the
    X101-DCN self-LD one (no launch, card vs CPU at 1x3x128x192); one bf16
    step of each. Returns the kernel's launch count over the main paths."""
    launches = 0
    for config in DCN_SERVE:
        def extra(model, bench, voting='r101' in config):
            out = dcn_device_share(
                torch, model, lambda: model.forward_test(bench))
            if voting:
                out.update(voting_serve(torch, model, bench))
            out.update(teacher_forward(torch, model))
            return out
        n, row = family_serve(torch, smi, config, warmup=2, timed=5,
                              phase='dcn_serve', extra=extra)
        check(row['dcn_layers'] == (30 if 'r101' in config else 26),
              f'{config}: {row["dcn_layers"]} DCN layers')
        launches += n
    layers = [dcn_layer_check(torch, *spec) for spec in DCN_LAYERS]
    emit(dict(phase='dcn_layers', nvidia_smi=smi, layers=layers))
    for config, warmup, timed in DCN_LD:
        n, row = ld_steps(torch, smi, config, 0, warmup, timed,
                          phase='dcn_train')
        check(row['dcn_layers_teacher'] > 0, f'{config}: no DCN teacher')
        launches += n
    for config, _, _ in DCN_LD:
        launches += ld_steps(torch, smi, config, 0, 1, 1, reference=False,
                             phase='dcn_bf16', dtype='bfloat16')[0]
    return launches

def teacher_reference(torch, np, config):
    """A served config as an LD config's teacher (seed 1, DCN offsets too,
    BNs folded, float32): its head outputs at 1x3x128x192 on the card
    against the same model on the CPU, within the bounds of the port's CPU
    tests against the JAX package (5e-3 max abs, 2e-4 median relative)."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import randomize_dcn_offsets
    from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    cfg = Config.fromfile(os.path.join(ROOT, config))
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(1))
    randomize_dcn_offsets(model, seed=1)
    pairs = fuse_conv_bn(model)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 128, 192)
                         .astype(np.float32))
    with torch.inference_mode():
        cpu_outs = model.eval()(x)
        card_outs = model.cuda()(x.cuda())
        worst, worst_med = head_output_diff(cpu_outs, card_outs)
    emit(dict(phase='res2net_reference', config=config, input='1x3x128x192',
              folded_pairs=pairs, max_abs_diff=worst,
              max_median_rel_diff=worst_med, tol_abs=5e-3,
              tol_median_rel=2e-4))
    check(worst < 5e-3 and worst_med < 2e-4,
          f'{config}: card vs CPU head outputs: max {worst}, median rel '
          f'{worst_med}')
    del model, card_outs
    torch.cuda.empty_cache()


def phase_res2net(torch, np, smi):
    """The imitation tables' Res2Net-101-DCN teacher rows at full width:
    forward_test of the GFLv2-R2N101-DCN config (1 launch a call, plain-keep
    identical dets, the DCN layers' and their conv_offset convs' device
    time), the same model as a teacher at batch 2 (BNs folded) and its
    head outputs on the card against the CPU; then the IMv2 configs that
    distil it, 5 launches a gibox step: the R101 student (2 + 5 steps,
    float32, card vs CPU at 1x3x128x192), the R2N101-DCN self student in
    its config's bf16 (1 + 3) and the X101-32x4d student (1 + 2). A
    student's DCN offsets start at the init's zero, as from ImageNet
    weights: the self student with seeded offsets (taps ~50 px off on its
    layer-3 activations) diverges by its third SGD step in float32 and
    bf16 alike (PERF.md, Findings). Returns the kernel's launch count over
    the main paths."""
    # one profiled call or step each: the profiler's post-processing of a
    # Res2Net-DCN call's ~12.5k kernels and ~40k host events takes seconds
    def extra(model, bench):
        out = dcn_device_share(torch, model,
                               lambda: model.forward_test(bench), iters=1)
        out.update(teacher_forward(torch, model, iters=1))
        return out
    warmup, timed = RES2NET_SERVE_CALLS
    launches, row = family_serve(torch, smi, RES2NET_TEACHER, warmup=warmup,
                                 timed=timed, phase='res2net_serve',
                                 extra=extra)
    check(row['backbone'] == 'Res2Net' and
          row['dcn_layers'] == RES2NET_DCN_LAYERS,
          f'{RES2NET_TEACHER}: {row["backbone"]} with {row["dcn_layers"]} '
          'DCN layers')
    teacher_reference(torch, np, RES2NET_TEACHER)
    for config, warmup, timed, dtype, cpu_check in RES2NET_IM:
        n, row = ld_steps(torch, smi, config, 5, warmup, timed,
                          phase='res2net_train', dtype=dtype,
                          cpu_check=cpu_check, student_offsets=False,
                          prof_steps=1)
        check(row['dcn_layers_teacher'] == RES2NET_DCN_LAYERS and
              row['loss_first']['loss_dfl'] == 0.0,
              f'{config}: {row["dcn_layers_teacher"]} teacher DCN layers, '
              f'loss_dfl {row["loss_first"]["loss_dfl"]}')
        launches += n
    check(launches == RES2NET_LAUNCHES,
          f'res2net phase: {launches} nms_keep launches, expected '
          f'{RES2NET_LAUNCHES}')
    return launches

# ---- ddp: data parallelism over ranks ----------------------------------------

DDP_RANKS = 2


def ddp_backend(torch):
    """NCCL takes a card a rank; ranks that share the one card run gloo."""
    return 'nccl' if torch.cuda.device_count() >= DDP_RANKS else 'gloo'


def rel_max_diff(np, got, want):
    """max |got - want| over max |want|, over every array of two dicts."""
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    return diff / max(float(np.abs(want[k]).max()) for k in want)


def ddp_step(torch, np, warmup=1, timed=3):
    """(a) The GI config's step at full width, float32, over 2 spawned
    ranks x 2 images of testing.detection_batch at 800x1344, against one
    process at 4 images over the same images and weights: each loss term
    within rtol 1e-3, the GI masks identical, the parameters after the
    step within 1e-5 of their largest value, 5 launches a step a rank.
    Returns the ranks' launches and the figures."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.testing import detection_batch_np, ld_step_rank, spawn
    cfg = Config.fromfile(os.path.join(ROOT, TRAIN_CONFIG))
    batch = detection_batch_np(2 * DDP_RANKS, 800, 1344, seed=0)
    steps = warmup + timed
    tmp = os.path.join(ROOT, 'work_dirs', 'chip_smoke_ddp', 'spawn')
    torch.cuda.empty_cache()
    # ---- the main path: each child counts its launches from 0 ----------
    ranks = spawn(ld_step_rank, DDP_RANKS, ddp_backend(torch), tmp,
                  device='cuda', args=(cfg, batch, steps, True))
    # --------------------------------------------------------------------
    ref = ld_step_rank(0, 1, 'cuda', cfg, batch, steps)
    torch.cuda.empty_cache()
    for r, out in enumerate(ranks):
        bad = {k: (v, ref['metrics'][k]) for k, v in out['metrics'].items()
               if abs(v - ref['metrics'][k]) >
               1e-3 * abs(ref['metrics'][k]) + 1e-7}
        check(sorted(out['metrics']) == sorted(ref['metrics']) and not bad,
              f'ddp rank {r}: loss terms off the one-process step: {bad}')
        check(out['launches'] == 5,
              f'ddp rank {r}: {out["launches"]} launches a step, not 5')
    check(ref['launches'] == 5, f'one process: {ref["launches"]} launches')
    same_masks = all(np.array_equal(np.concatenate(
        [out['masks'][lvl] for out in ranks]), m)
        for lvl, m in enumerate(ref['masks']))
    check(len(ref['masks']) == 5 and same_masks,
          'ddp: the ranks\' GI masks differ from the one-process ones')
    params_rel = rel_max_diff(np, ranks[0]['params'], ref['params'])
    grads_rel = rel_max_diff(np, ranks[0]['grads'], ref['grads'])
    check(params_rel <= 1e-5,
          f'ddp: parameters after the step {params_rel:.3g} off (rel max)')
    rank_ms = [sum(out['step_ms'][warmup:]) / timed for out in ranks]
    one_ms = sum(ref['step_ms'][warmup:]) / timed
    return sum(out['launches'] * steps for out in ranks), dict(
        backend=ddp_backend(torch), ranks=DDP_RANKS, batch_per_rank=2,
        hw=[800, 1344], loss=ranks[0]['metrics'],
        loss_one_process=ref['metrics'],
        loss_max_rel_diff=max(abs(v - ref['metrics'][k]) /
                              max(abs(ref['metrics'][k]), 1e-12)
                              for k, v in ranks[0]['metrics'].items()),
        gi_masks_identical=True, gi_picks=[float(m.sum())
                                           for m in ref['masks']],
        params_rel_max_diff=params_rel, grads_rel_max_diff=grads_rel,
        step_ms_ranks=[out['step_ms'] for out in ranks],
        step_ms_ranks_mean=rank_ms, step_ms_one_process=ref['step_ms'],
        step_ms_one_process_mean=one_ms,
        collectives_rank0=ranks[0]['collectives'],
        grad_allreduce_ms_ranks=[out['allreduce_ms'] for out in ranks],
        grad_bytes=ranks[0]['grad_bytes'],
        peak_bytes_ranks=[out['peak_bytes'] for out in ranks],
        peak_bytes_one_process=ref['peak_bytes'],
        launches_per_step_ranks=[out['launches'] for out in ranks])


def torchrun(args, timeout=600):
    """`python -m torch.distributed.run --standalone` with DDP_RANKS ranks
    on this script's worker mode; raises unless every rank exits 0. On a
    time-out the whole process group is killed."""
    import signal
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(DDP_RANKS), os.path.abspath(__file__),
           *map(str, args)]
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    check(proc.returncode == 0,
          f'torchrun {args[:2]} exited {proc.returncode}:\n{out[-4000:]}')


def ddp_worker(argv):
    """torchrun's target in the ddp phase, one rank:
    `--ddp-train-worker OUT PREEMPT -- ARGS` runs tools/train.py's main on
    ARGS, recording this rank's img_ids, losses and launches a step (the
    `make_train_step` of train_detector wrapped; rank 0 raises SIGTERM
    after its step PREEMPT unless it is 0); `--ddp-test-worker OUT 0 --
    ARGS` runs tools/test.py's main. Writes OUT.rank<r>.pt."""
    import torch
    sys.path.insert(0, ROOT)
    import ld_tpu_torch.apis.train as train_api
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    # as the phases of this process: float32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mode, out, preempt = argv[0], argv[1], int(argv[2])
    rank = int(os.environ['RANK'])
    nms_keep.launches = 0
    record = []
    if mode == '--ddp-train-worker':
        instrument_steps(train_api, record,
                         preempt_after=preempt if rank == 0 and preempt
                         else None)
        ret = load_tool('train').main(argv[4:])
        res = dict(preempted=ret['preempted'], step=ret['step'])
    else:
        res = dict(results=load_tool('test').main(argv[4:])['results'])
    torch.save(dict(res, record=record, launches=nms_keep.launches,
                    peak_bytes=torch.cuda.max_memory_allocated()),
               f'{out}.rank{rank}.pt')
    return 0


def ddp_read(torch, out):
    return [torch.load(f'{out}.rank{r}.pt', weights_only=False)
            for r in range(DDP_RANKS)]


def ddp_cli(torch, np, work, steps_per_epoch=3, epochs=2):
    """(b) tools/train.py --launcher pytorch over 2 ranks with the runtime
    phase's config (12 + 8 synthetic images, 2 epochs, the eval hook):
    through, and preempted by a SIGTERM to rank 0 after step 3 and resumed
    (the same img_ids per rank, the same LR per step); rank 0 alone
    writes; the checkpoint loads into a one-process model; 5 launches a
    step a rank plus 1 an eval batch. (c) tools/test.py --launcher pytorch
    --eval bbox on that checkpoint: every test image once, in dataset
    order, the detections those of a one-process forward_test over the
    same per-rank batches. Returns the launches and the figures."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.data import (DevicePrefetcher, build_dataloader,
                                   build_dataset)
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.utils.checkpoint import load_checkpoint
    teacher_path = os.path.join(work, 'teacher_r101_seed1.pth')
    teacher = build_detector(Config.fromfile(os.path.join(
        ROOT, runtime_cfg(teacher_path).model.teacher_config)).model)
    teacher.init_weights(torch.Generator().manual_seed(1))
    torch.save(dict(state_dict=teacher.state_dict()), teacher_path)
    del teacher
    cfg = runtime_cfg(teacher_path)
    cfg.data['test'] = cfg.data['val']
    # a model 6 steps old scores below the config's 0.05
    cfg.model.test_cfg.score_thr = 0.001
    cfg_path = os.path.join(work, 'ddp_cfg.py')
    cfg.dump(cfg_path)
    opts = ['--cfg-options', f'dist_params.backend={ddp_backend(torch)}']
    steps = steps_per_epoch * epochs
    runs, seconds = {}, {}
    for name, preempt in (('through', 0), ('preempted', 3),
                          ('resumed', 0)):
        wd = os.path.join(work, 'through' if name == 'through' else 'cut')
        args = ['--ddp-train-worker', os.path.join(work, name), preempt,
                '--', cfg_path, '--work-dir', wd, '--launcher', 'pytorch',
                *opts]
        if name == 'resumed':
            args += ['--resume-from', wd]
        t0 = time.perf_counter()
        torchrun(args)
        seconds[name] = time.perf_counter() - t0
        runs[name] = ddp_read(torch, os.path.join(work, name))
        if name == 'preempted':
            ckpts_at_preemption = sorted(os.listdir(os.path.join(
                wd, 'checkpoints')))
    through, cut = runs['through'], runs['preempted']
    for r in range(DDP_RANKS):
        rec = through[r]['record']
        check(len(rec) == steps and all(x['launches'] == 5 for x in rec),
              f'ddp cli rank {r}: {len(rec)} steps, launches '
              f'{[x["launches"] for x in rec]}')
        check(through[r]['launches'] == 5 * steps + epochs,
              f'ddp cli rank {r}: {through[r]["launches"]} launches, not '
              f'{5 * steps + epochs} (5 a step, 1 an eval batch)')
        check(cut[r]['preempted'] and cut[r]['step'] == 3,
              f'ddp cli rank {r}: preempted at step {cut[r]["step"]}')
        check([x['img_ids'] for x in cut[r]['record'] +
               runs['resumed'][r]['record']] ==
              [x['img_ids'] for x in rec],
              f'ddp cli rank {r}: the resumed img_ids differ')
        bad = [k for x in rec for k, v in x['losses'].items()
               if not math.isfinite(v)]
        check(not bad, f'ddp cli rank {r}: non-finite {bad[:3]}')
    check(all(set(a) & set(b) == set() for a, b in zip(
        *[[x['img_ids'] for x in through[r]['record']]
          for r in range(DDP_RANKS)])), 'ddp cli: a step ran an image twice')
    check(ckpts_at_preemption == ['3.pth'],
          f'ddp cli: checkpoints at preemption {ckpts_at_preemption}')
    logs = {n: read_log(os.path.join(work, n)) for n in ('through', 'cut')}
    lr = {n: [x['lr'] for x in log if x['mode'] == 'train']
          for n, log in logs.items()}
    check(lr['through'] == lr['cut'] and len(lr['through']) == steps,
          f'ddp cli: LR per step {lr}')
    with open(os.path.join(work, 'through', 'train.log')) as f:
        check(f.read().count('start training') == 1,
              'ddp cli: more than one rank wrote train.log')
    check(len([x for x in logs['through'] if x['mode'] == 'val']) == epochs,
          'ddp cli: val lines')
    ckpt = os.path.join(work, 'through', 'checkpoints', f'{steps}.pth')
    check(sorted(os.listdir(os.path.join(work, 'through', 'checkpoints')))
          == [f'{steps}.pth'] and os.path.exists(os.path.join(
              work, 'through', 'best_bbox_mAP.pth')),
          'ddp cli: checkpoints')
    model = build_detector(cfg.model)
    load_checkpoint(model, ckpt)

    # (c) the test CLI on the checkpoint
    out = os.path.join(work, 'test')
    t0 = time.perf_counter()
    torchrun(['--ddp-test-worker', out, 0, '--', cfg_path, ckpt, '--eval',
              'bbox', '--launcher', 'pytorch', *opts])
    seconds['test'] = time.perf_counter() - t0
    tests = ddp_read(torch, out)
    val = build_dataset(cfg.data['val'])
    results = tests[0]['results']
    check(len(results) == len(val) and all(len(x['labels']) for x in
                                            results),
          'ddp test: not one result with detections an image')
    model.cuda().eval()
    diff, compared = 0.0, set()
    with torch.inference_mode():
        for r in range(DDP_RANKS):
            loader = build_dataloader(val, 4, DDP_RANKS, cfg.pad_to,
                                      max_gts=1, shuffle=False, rank=r)
            for batch in DevicePrefetcher(loader, 'cuda'):
                dets, labels, valid = (o.cpu().numpy() for o in
                                       model.forward_test(batch,
                                                          rescale=True))
                for i, idx in enumerate(batch['img_idx']):
                    if idx in compared:
                        continue
                    compared.add(int(idx))
                    got = results[idx]
                    check(np.array_equal(got['labels'],
                                         labels[i][valid[i]]),
                          f'ddp test: image {idx} labels differ')
                    diff = max(diff, float(np.abs(
                        got['boxes'] - dets[i][valid[i]]).max()))
    check(compared == set(range(len(val))) and diff <= 1e-4,
          f'ddp test: detections {diff:.3g} off one process')
    launches = sum(x['launches'] for x in through) + \
        sum(x['launches'] for x in runs['preempted']) + \
        sum(x['launches'] for x in runs['resumed']) + \
        sum(x['launches'] for x in tests)
    check(all(x['launches'] == 1 for x in tests),
          f'ddp test: launches {[x["launches"] for x in tests]}, not 1 a '
          'rank')
    return launches, dict(
        cli_seconds=seconds, cli_steps=steps,
        cli_launches_ranks=[x['launches'] for x in through],
        cli_step_ms_rank0=[x['time'] * 1e3 for x in logs['through']
                           if x['mode'] == 'train'],
        cli_lr=lr['through'], cli_peak_bytes_ranks=[
            x['peak_bytes'] for x in through],
        checkpoints_at_preemption=ckpts_at_preemption,
        test_images=len(val), test_dets_max_abs_diff=diff,
        test_launches_ranks=[x['launches'] for x in tests])


def phase_ddp(torch, np, smi):
    """The ddp phase: (a) one step over 2 ranks against one process, (b)
    the training CLI over 2 ranks, preempted and resumed, (c) the test CLI
    over 2 ranks, (d) their figures beside the card's name and power
    limit. On one card the ranks share it over gloo: these figures are the
    collective path's cost there, not a scaling figure. Returns the
    kernel's launches over the ranks' main paths."""
    import shutil
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_ddp')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    step_launches, step_row = ddp_step(torch, np)
    cli_launches, cli_row = ddp_cli(torch, np, work)
    emit(dict(phase='ddp', config=TRAIN_CONFIG, nvidia_smi=smi,
              launches=step_launches + cli_launches, **step_row, **cli_row,
              seconds=time.perf_counter() - t0))
    shutil.rmtree(work, ignore_errors=True)
    return step_launches + cli_launches


def main():
    import torch
    if len(sys.argv) > 1 and sys.argv[1].startswith('--ddp-'):
        return ddp_worker(sys.argv[1:])
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
    try:
        import cv2  # noqa: F401 — only decoding image files needs it
        cv2_imports = True
    except ImportError:
        cv2_imports = False
    emit(dict(phase='device', name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), nvidia_smi=smi,
              python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_benchmark=torch.backends.cudnn.benchmark,
              cv2_imports=cv2_imports))

    t0 = time.perf_counter()
    lib = nms_cuda.build()
    emit(dict(phase='build', library=os.path.relpath(lib),
              seconds=time.perf_counter() - t0))

    max_err, main_case, tta_case = phase_kernel(torch)
    model, launches, bench = phase_e2e(torch, np)
    phase_profile(torch, model, bench)
    phase_reference(torch, np, model)
    del model, bench
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, smi)
    runtime_launches = phase_runtime(torch, smi)
    voc_launches, merge = phase_voc(torch, np, smi)
    family_launches = phase_gfl_family(torch, smi)
    bf16_launches = phase_bf16(torch, smi)
    t0 = time.perf_counter()
    dcn_launches = phase_dcn(torch, smi)
    emit(dict(phase='dcn_done', seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res2net_launches = phase_res2net(torch, np, smi)
    emit(dict(phase='res2net_done', seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    ddp_launches = phase_ddp(torch, np, smi)

    print(smi.splitlines()[0], flush=True)
    emit(dict(kernels=[dict(
        name='nms_keep', route='cuda', source='ld_tpu_torch/csrc/nms_keep.cu',
        replaces='ld_tpu/ops/pallas_nms.py:23',
        launches=(launches + train_launches + runtime_launches +
                  voc_launches + family_launches + bf16_launches +
                  dcn_launches + res2net_launches + ddp_launches),
        launches_serve=launches, launches_train=train_launches,
        launches_runtime=runtime_launches, launches_voc=voc_launches,
        launches_gfl_family=family_launches, launches_bf16=bf16_launches,
        launches_dcn=dcn_launches, launches_res2net=res2net_launches,
        launches_ddp=ddp_launches,
        max_abs_err=max_err, ms=main_case['ms'],
        plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
        bound_by=main_case['bound_by'], library_ms=None,
        device_ms=main_case['device_ms'], host_ms=main_case['host_ms'],
        **{f'device_ms_{n}': main_case[f'device_ms_{n}']
           for n in NMS_KERNELS},
        ms_k2048=tta_case['ms'], device_ms_k2048=tta_case['device_ms'],
        plain_ms_k2048=tta_case['plain_ms'],
        bound_ms_k2048=tta_case['bound_ms'],
        ms_tta_merge=merge['ms'], device_ms_tta_merge=merge['device_ms'],
        plain_ms_tta_merge=merge['plain_ms'])]))
    emit(dict(ok=True, device=dict(platform='gpu',
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
