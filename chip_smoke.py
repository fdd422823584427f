"""Drive the ld_tpu_torch serving, training, training-runtime and evaluation
paths, the other GFL-family heads, the configs' bf16 dtype, the DCN /
ResNeXt rows, the Res2Net-101-DCN teacher rows, data-parallel training
and evaluation, the synthetic train-to-AP harness, the AP landscape, the
HTTP server, the export, the classic one-stage heads, the two-stage
stack, Mask R-CNN, the cascades (Cascade R-CNN, Cascade Mask R-CNN, HTC),
the HRNet and RegNet detectors, the ResNet's plugin, 'DCN' and GN + WS
variants, the LVIS / crop / augmentation / robustness data paths,
VarifocalNet, Guided Anchoring, RepPoints, FoveaBox, SSD, Mask Scoring
R-CNN, the ResNeSt detectors, PAA, FSAF, FreeAnchor, SABL, DetectoRS, the
FPG, NAS-FPN, NAS-FCOS, CARAFE and PAFPN necks, Grid R-CNN and PointRend,
Libra R-CNN, PISA, GRoIE and hard mining, SCNet, the C4 shared res5 head,
deformable RoI pooling, Double-Head and Dynamic R-CNN, the mmdet v1
anchors and the GHM losses on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root, on a GPU host
    python3 chip_smoke.py --phases fovea_ssd ms_rcnn_resnest    # alone

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
               (2048, 1), (16800, 1)}:
               CUDA-event time per call over back-to-back calls, the host's
               time to issue them (and to launch the kernel without the
               registered operator's dispatch), each kernel's device time from
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
               seed 1 with its BNs folded, gibox imitation) for 1 + 2 steps
               at batch 2, 800x1344, 5 kernel launches a step, its GI masks
               and loss_im identical with the plain keep mask; the IMv2
               config for one step (loss_dfl 0, 5 launches); LD on ATSS-,
               FCOS- (caffe-style R101 teacher) and Retina-GFL
               (configs/ld/ld_r50_{atss,fcos}_r101_1x.py, ld_retina_r50_1x.py)
               for 1 + 2 steps each, no launch; every loss finite; the
               first step of each (but IMv2) at 1x3x128x192 on the card
               against the CPU, rtol 1e-3 a term (and identical GI masks);
               step, teacher and profile figures. Then forward_test at
               800x1344 of GFocalV2-R50, ATSS-GFL-R50, FCOS-GFL-R50 and
               Retina-GFL at R50 (cls prediction bias 0): 1 launch a call,
               the detections bit-identical with the plain keep mask, the
               first detection's score the largest class probability, and
               the NMS candidate count K.
 10. bf16, dcn, res2net — the configs' bf16 dtype; the DCN / ResNeXt
               rows; the imitation tables' Res2Net-DCN teacher rows. The
               dcn and res2net phases run their 101-layer configs at depth
               50 (`DEPTH_CUT`; widths, heads and schedules kept, the
               config and its teacher written under work_dirs/
               chip_smoke_depth/ by `depth_config`): GFL-R50-DCN (13 DCN
               layers) and GFL-X50-32x4d-DCN (9) served 1 + 3 calls, the
               DCN LD configs' students and teachers at 50; forward_test
               of configs/imv2/gflv2_r2n101_dcn_fpn_2x.py at depth 50 and
               800x1344 (1 launch a call, 39 DCN layers, their device
               share), the same model as a folded teacher at batch 2, its
               head outputs at 1x3x128x192 on the card against the CPU, and
               the three IMv2 configs that distil it at batch 2, 800x1344
               (students at 50; 5 launches a step; the first student's
               first step against the CPU, the self student in its bf16
               dtype); the phase's launch count must equal
               RES2NET_LAUNCHES.
 11. ddp     — data parallelism over 2 ranks sharing the card (gloo; NCCL
               where there is a card a rank): (a) 3 steps of the GI config
               at full width, float32, batch 2 a rank at 800x1344 in the 2
               ranks of (b)'s torchrun launch, its first job, against one
               process at batch 4 over the same
               images and weights (loss terms rtol 1e-3, GI masks
               identical, parameters after the step within 1e-5 of their
               largest value, 5 launches a step a rank); (b) this script
               in its worker mode under `python -m torch.distributed.run
               --nproc_per_node 2` on tools/train.py --launcher pytorch
               with the runtime phase's config, through (one launch), and
               preempted by a SIGTERM to rank 0 after step 3 and resumed
               (the same img_ids a rank, the same LR a step; rank 0 alone
               writes; 5 launches a step a rank + 1 an eval batch); (c) in
               the second launch, after the resumed run, tools/test.py
               --launcher pytorch --eval bbox (every test image once, in
               dataset order, the detections those of a one-process
               forward_test of the same per-rank batches); (d)
               step ms against one process, the gradient all-reduce's ms,
               peak memory a rank, the phase's seconds: the collective
               path's cost on a shared card, not a scaling figure.
 12. harness — ld_tpu_torch/tools/analysis_tools/ld_gain_experiment.py on
               its own 96 + 32 drawable synthetic images at 160x224
               (teacher 2 epochs, students 1), cuDNN deterministic: every
               loss finite, no launch a step, 1 an eval batch; then the LD
               student with its LD, VLR and KD weights 0 against the
               baseline, losses within rtol 1e-5 a step; the three mAPs and
               steps/s;
 13. landscape — ap_landscape.py on the harness's teacher and LD student
               (their configs dumped beside the checkpoints, the held-out
               split as test set): every statistic finite, Pearson in
               [-1, 1], no launch;
 14. serve_http — tools/deployment/serve.py on GFL-R50 at 800x1344 (the
               e2e phase's weights written to a `.pth`, max batch 4) and 12
               concurrent seeded JPEG requests: every reply 200 and equal
               to its batch (from its `X-Batch` header) run again, each
               image's head outputs at batch 1 within 1e-4 of its slot in
               that batch (relative past 1: a coordinate past 1024 px has
               a float32 spacing of 1.22e-4), one launch a batch formed;
               the replies equal to batch 1's detections counted (float32
               noise between batch sizes reorders near-equal NMS
               candidates of random weights); latency p50 / p90, images/s,
               the batches formed, the host pipeline's share;
 15. export  — tools/deployment/export.py on the same model at 1x3x800x1344
               (one ld_tpu_torch::nms_keep node in the graph), its
               forward_test ms against eager, run_export.py in a fresh
               interpreter (detections within 1e-4 of eager; 1 launch
               counted there, of the framework only the operator's module
               loaded), one call's keep mask identical with nms_keep_ref.
 16. classic_heads — the plain one-stage heads at full width, float32,
               random weights from seed 0: RetinaNet R50, FCOS R50-caffe
               (GN head) and ATSS R50 (configs/retinanet/, fcos/, atss/),
               each `forward_test` at 800x1344 (1 launch a call, the
               detections bit-identical with the plain keep mask, the first
               detection's score the largest class probability), 1 + 2
               training steps at batch 2, 800x1344 (every loss finite, no
               launch), and at 1x3x128x192 the head outputs and the first
               step's losses on the card against the CPU (5e-3 / 2e-4;
               rtol 1e-3 a term). Budget 45 s.
 17. two_stage — configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py at full
               width, float32, seed 0: `inference_detector` on 4 seeded
               requests and `forward_test` at 800x1344, batch 1 and 2 (2
               launches a call: the RPN proposals of the batch, K = 4819 an
               image, and the RoI head's class-aware NMS, K = 1024; both
               keep masks, the proposals and the detections identical with
               the plain keep mask); 2 + 5 training steps at batch 2 (the
               config's samplers, 1 launch a step, every loss finite, peak
               memory, the device's top ops); at 1x3x128x192 the FPN and
               RPN outputs, the RPN losses and the RoI losses on the CPU's
               proposals, card against CPU, with samplers that pick every
               candidate (5e-3 / 2e-4; rtol 1e-3 a term); then 1 + 2 steps
               of the KD two-stage detector (R101 teacher from
               faster_rcnn_r101_fpn_1x_coco.py, seed 1, BNs folded; R50
               student; loss_rpn_kd and loss_rpn_ld finite; 1 launch a
               step); then the kernel alone on the RPN's own sorted
               candidates at K = 4819, B = 1 and 2: bit-identical with
               nms_keep_ref, event / host / device ms, the plain version's
               ms and the bound. Budget 90 s.
 18. mask_rcnn — configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py at full
               width, float32, seed 0: `forward_test` at batch 1 and 2 with
               its masks (2 launches a call, outputs identical with the
               plain keep mask); 2 + 5 steps with gt_masks through
               _base_/datasets/coco_instance.py's train pipeline (the mask
               tower on the 128-roi positive slice), 1 + 2 with it on every
               roi (the same first loss_mask within 1e-4); the card against
               the CPU at 1x3x128x192 on the top 50 proposals (masks within
               5e-3); 1 + 2 steps of
               the X101-32x8d config through its own mask-loading pipeline;
               `eval_detector` -> `evaluate(['bbox', 'segm'])` over 8
               polygon images (2 launches a batch; the gts as detections
               score segm and bbox AP 1.0). Budget 90 s.
 19. cascade — configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py,
               cascade_mask_rcnn_r50_fpn_1x_coco.py and
               configs/htc/htc_r50_fpn_1x_coco.py at full width, float32,
               seed 0 (each stage's fc_cls x 100 when served):
               `forward_test` at batch 1 and 2 (HTC: 1), 2 + 5 calls each (2
               launches a call: the RPN's and the last stage's NMS; outputs
               identical with the plain keep mask; Cascade Mask R-CNN's
               masks the stages' average); 1 + 2 steps each at batch 2 with
               gt_masks through coco_instance.py's train pipeline (1 launch
               a step; every stage's losses, HTC's loss_semantic_seg); for
               Cascade Mask R-CNN and HTC the card against the CPU at
               1x3x128x192 on the top 20 proposals (rtol 1e-3 a loss,
               masks within 5e-3), and Cascade Mask R-CNN's evaluation over
               the polygon set (AP 1.0 for the gts); then the kernel alone
               on a batch-2 call's RPN (K = 4819) and last-stage (K = 1024)
               NMS inputs. Launches must equal CASCADE_LAUNCHES (87).
               Budget 75 s.
 20. hrnet_regnet — full width, float32, seed 0, 800x1344:
               configs/hrnet/faster_rcnn_hrnetv2p_w40_1x_coco.py (fc_cls x
               100): `forward_test` at batch 1 and 2, 1 + 3 calls each (2
               launches a call, outputs identical with the plain keep mask),
               its HRNet's device ops, device ms and busy share a forward,
               1 + 3 steps at batch 2 under the profiler (1 launch a step),
               the card against the CPU at 1x3x128x192 on the top 50
               proposals (rtol 1e-3 a loss, FPN / RPN outputs 5e-3), then
               1 + 3 calls in the config's own bf16 dtype; FCOS
               HRNetV2p-W32 (HRFPN at stride 2): 1 + 5 calls (1 launch a
               call), 1 + 2 steps (none); Mask R-CNN RegNetX-3.2GF: 1 + 3
               calls at batch 1 and 2, 1 + 3 steps with gt_masks through
               coco_instance.py's pipeline, the card against the CPU (masks
               within 5e-3); its mdconv c3-c5 config 1 + 2 steps with
               seeded offsets on its 23 grouped DCN conv2 layers, and one
               such layer (432 channels, 9 groups) against the CPU within
               1e-4 of its largest output; RetinaNet RegNetX-800MF 1 + 5
               calls. Launches must equal HRNET_REGNET_LAUNCHES (63).
               Budget 80 s.
 21. resnet_variants — full width, float32, seed 0, 800x1344, every
               plugin's zero-init gate and every DCN offset conv seeded:
               configs/gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py and
               configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py
               (`forward_test` at batch 1 and 2, 1 + 3 calls each, 2
               launches a call; 1 + 3 steps with gt_masks through
               coco_instance.py's pipeline under the profiler, 1 launch a
               step; the card against the CPU at 1x3x128x192 on the top
               50 proposals: losses rtol 1e-3, outputs 5e-3, masks 5e-3),
               configs/empirical_attention/faster_rcnn_r50_fpn_attention_
               1111_1x_coco.py (the same, unmasked, with the attention
               blocks' share of a step's device time, and one c4 attention
               block, 2x256x50x84, against the CPU within 1e-4 of its
               largest output and residual), configs/dcn/faster_rcnn_r50_
               fpn_dconv_c3-c5_1x_coco.py (1 + 5 calls) and the X101-32x4d
               DCN + GCNet Cascade Mask R-CNN of configs/gcnet/ at depth 50
               (1 + 2 calls). Launches must equal RESNET_VARIANTS_LAUNCHES (78).
               Budget 80 s.
 22. data_host — the host side of the data layer on the card's machine:
               a seeded LVIS-v1 set (1203 categories, 8 JPEGs at COCO sizes
               named by `coco_url` only, polygons) under configs/lvis/
               mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py
               (ClassBalancedDataset over LVISV1Dataset): 1 + 3 steps at
               batch 2 through the loader at the config's multi-scale size
               (1 launch a step, loss_mask finite), `forward_test` at batch
               1 under its test config (2 launches a call, 300 detections,
               the RoI NMS's K), `eval_detector` -> `evaluate(['bbox',
               'segm'])` of the 8 images (2 launches a batch; the gts as
               detections score AP 1.0); 2 steps at batch 2 of configs/fpg/
               faster_rcnn_r50_fpn_crop640_50e_coco.py through its own
               RandomCrop pipeline (640x640 batches, 1 launch a step); the
               host ms an 800x1333 image of PhotoMetricDistortion, Expand +
               MinIoURandomCrop, CutOut, AutoAugment and each corruption at
               severity 3; ld_tpu_torch/tools/analysis_tools/
               test_robustness.py on GFL-R50 over 8 synthetic COCO images,
               two corruptions at severity 3 and the clean run (1 launch an
               eval batch). Launches must equal DATA_HOST_LAUNCHES.
               Budget 60 s.
 23. vfnet   — configs/vfnet/vfnet_r50_fpn_1x_coco.py at full width,
               float32, seed 0 (vfnet_cls bias 0): `forward_test` at
               800x1344, 1 + 5 calls at batch 1 and 1 + 3 at batch 2 (1
               launch a call, the detections identical with the plain keep
               mask), one profiled call with the star DeformConv's share of
               device time (10 calls a forward: 5 levels x reg and cls),
               1 + 3 training steps at batch 2 (no launch), the head
               outputs (5e-3 / 2e-4), the first step's losses (rtol 1e-3)
               and the decode of the same outputs (labels and kept set
               equal, boxes and scores within 1e-4) at 1x3x128x192 on the
               card against the CPU; the widest config, vfnet_x101_64x4d_
               fpn_mdconv_c3-c5_mstrain_2x_coco.py at depth 50, 1 + 3 calls
               at batch 1.
               Launches must equal VFNET_LAUNCHES. Budget 60 s.
 24. guided_anchoring — configs/guided_anchoring/ at full width, float32,
               seed 0 (each adaption's offset conv seeded off the grid,
               the class and location biases 0): GA-RetinaNet R50
               `forward_test` at 800x1344, 1 + 3 calls at batch 1 (1
               launch a call, the detections identical with the plain keep
               mask; one profiled call with the adaption DeformConv's share
               of device time, 10 calls a forward) and 1 + 2 at batch 2,
               1 + 2 steps at batch 2 (no launch), its outputs, first-step
               losses and decode at 1x3x128x192 on the card against the
               CPU; GA-Faster R-CNN R50 1 + 3 calls at batch 1 (2 launches
               a call: its GA-RPN's proposals at K = 1000, the RoI head's
               at 1024), 1 + 2 steps at batch 2 (1 launch a step; the
               ApproxMaxIoU matrix at strides 4-64 in its peak memory),
               against the CPU (`roi_reference`, the proposals' decode);
               GA-RPN R50 1 + 2 calls at batch 1 (1 launch a call, with
               the adaption DeformConv's share). Launches must equal
               GA_LAUNCHES. Budget 45 s.
 25. reppoints — configs/reppoints/ at full width, float32, seed 0 (the
               init points seeded off the grid, the class bias 0): the
               moment R50 config 1 + 3 calls at batch 1 (with the point
               DeformConvs' share) and 1 + 2 at batch 2, 1 + 2 steps; the
               grid config (minmax, grid points) 1 + 2 calls and 1 + 1
               steps; each against the CPU at 1x3x128x192 (outputs,
               losses, decode); the X101-32x4d DCN c3-c5 config at depth
               50, 1 + 2 calls. 1 launch a call, none a step; launches must equal
               RP_LAUNCHES. Budget 45 s.
 26. fovea_ssd — FoveaBox and SSD at full width, float32, seed 0:
               FoveaBox R50 1 + 3 calls at batch 1 and 1 + 2 at batch 2
               (800x1344), 1 + 2 steps at batch 2; FoveaBox-align R50 (its
               offset conv seeded off the grid) 1 + 3 calls with the align
               DeformConv's share of one profiled call (5 calls a
               forward), 1 + 2 steps; the FoveaBox-align R101 config at
               depth 50, 1 + 2 calls;
               each R50 FoveaBox against the CPU at 1x3x128x192 (outputs,
               first-step losses, decode); SSD300 1 + 5 calls at batch 1
               and 1 + 3 at batch 8 (300x300; 200 detections an image, the
               NMS at K = 1024 of 8732 x 80 pairs, identical with the
               plain keep mask), 1 + 3 steps at batch 8, against the CPU at
               1x3x300x300; SSD512 1 + 3 calls at batch 1 and 1 + 2 steps
               at batch 8. 1 launch a call, none a step; launches must
               equal FOVEA_SSD_LAUNCHES. Budget 40 s.
 27. ms_rcnn_resnest — Mask Scoring R-CNN and ResNeSt at full width,
               float32, seed 0 (fc_cls peaked for serving): MS R-CNN R50
               1 + 3 calls at batch 1 and 2 with masks, 1 + 2 steps at
               batch 2 with box-region gt masks (loss_mask_iou), against
               the CPU (`roi_reference`: losses, masks); MS R-CNN
               X101-64x4d at depth 50, 1 + 2 calls; the ResNeSt-50 Faster R-CNN 1 + 3
               calls at batch 1 and 2, 1 + 2 steps at batch 2 with its BNs
               live (the running statistics' change reported), its
               outputs at 1x3x128x192 and its first losses at 2x3x128x192
               in training against the CPU (the trunk in float64 on both:
               its live 2-value BNs amplify float32 rounding; the float32
               differences reported); Cascade Mask R-CNN S101 at depth 50,
               1 + 2 calls, 1 + 2 steps with masks. 2 launches a call, 1 a step;
               launches must equal MS_RESNEST_LAUNCHES. Budget 50 s.
 28. paa_fsaf_freeanchor, sabl — PAA, FSAF and FreeAnchor R50; the SABL
               RetinaNet, Faster and Cascade R-CNN R50 (see their
               functions). Budgets 25 s each.
 29. detectors_necks — DetectoRS HTC R50 (SAC + RFP) and Cascade R-CNN
               R50 RFP at 800x1344, FPG Faster R-CNN and NAS-FPN RetinaNet
               at 640x640, NAS-FCOS, CARAFE and PAFPN Faster R-CNN at
               800x1344; full width, float32, seed 0 (fc_cls peaked, a
               dense head's cls bias 0): each 1 + 2 calls at batch 1 (the
               detections identical with the plain keep mask), 1 + 2
               steps at its config's samples_per_gpu (8 for FPG, 4 for
               NAS-FCOS, 2 for the rest; HTC with box-region gt masks),
               against the CPU (`roi_reference` at 1x3x128x192, HTC's on
               its top 20 proposals; `dense_reference` at 1x3x128x192,
               NAS-FPN's at 1x3x128x256). 2 launches a two-stage call, 1 a
               single-stage call, 1 a two-stage step; launches must equal
               DN_LAUNCHES. Budget 45 s.
 30. grid_point_rend — Grid R-CNN and PointRend R50 the same way at
               800x1344 (PointRend stepped with box-region gt masks: its
               first step has loss_point, Grid R-CNN's loss_grid);
               launches must equal GP_LAUNCHES. Budget 15 s.
 31. libra_pisa — Libra Faster R-CNN R50 (FPN + non-local BFP,
               CombinedSampler), Libra RetinaNet R50 (BalancedL1; its cls
               conv x 10 behind the BFP), PISA Faster and Mask R-CNN (box-
               region gt masks) and PISA RetinaNet R50 the same way (each
               RoI head's reference sampler its config's type at num = the
               candidates; loss_carl in each PISA model's first step);
               PISA SSD300 1 + 2 calls at batch 1, 1 + 2 steps at batch 8,
               against the CPU at 300x300. Launches must equal
               LP_LAUNCHES. Budget 40 s.
 32. groie_mining — GRoIE Faster, Mask and Grid R-CNN R50 and Faster
               R-CNN R50 with OHEM and with ScoreHLR (fc_cls peaked in
               their steps and references) the same way; then the sampler
               check: every new sampler on the card and on the CPU, on
               draws made on the CPU and a full-width step's candidates,
               selections identical, ScoreHLR's weights within 1e-6.
               Launches must equal GM_LAUNCHES. Budget 30 s.
 33. roi_variants — SCNet, Faster and Mask R-CNN C4 (caffe), Faster R-CNN
               with deformable and modulated deformable RoI pooling,
               Double-Head and Dynamic R-CNN, all R50 at 800x1344, float32,
               seed 0 (`VAR_MODELS`): `forward_test` at batch 1 and 2, 1 +
               2 calls each (2 launches a call; identical with the plain
               keep mask; the C4 mask model's 14x14 masks), the deformable
               RoI pooling's share of a call's device time and its bound;
               1 + 1 steps at batch 2 (box-region gt masks for SCNet and
               the C4 Mask R-CNN; `loss_glbctx`); the card against the CPU
               at 1x3x128x192 (`roi_reference`; Dynamic R-CNN's IoU
               thresholds and SmoothL1 beta, `dynamic_reference`); then
               nms_keep alone on the C4 RPN's K = 6000 (test) and 12000
               (training) candidates at B = 1 and 2. Launches must equal
               VAR_LAUNCHES. Budget 45 s.
 34. legacy_ghm — RetinaNet R50 with GHM-C / GHM-R: 1 + 1 steps at batch
               2, against the CPU at 1x3x128x192 (outputs, losses,
               decode); Faster R-CNN and RetinaNet R50 v1 served 1 + 2
               calls at batch 1, their anchors (the RPN's plain at centre
               offset 0.5, the RetinaNet's mmdet v1 layout) on the card
               equal to the CPU's, the decode of the CPU's outputs against
               the CPU. Launches must equal LG_LAUNCHES. Budget 15 s.
 35. crpn_tood — the Cascade RPN Faster R-CNN R50-caffe (fc_cls x 100),
               the Cascade RPN alone and TOOD R50 (cls biases 0, offset
               branch seeded) at full width, float32, seed 0, 800x1344:
               1 + 2 calls at batch 1 and 2 (2 launches a Faster R-CNN
               call, 1 an RPN or TOOD call; outputs identical with the
               plain keep mask; the adaptive convs' share of a call's
               device time and their gather bound), 1 + 1 steps at batch 2
               (1 launch a Faster R-CNN step), the card against the CPU at
               1x3x128x192 (outputs, every loss term, the decode; the
               RegionAssigner, MaxIoU and TaskAlignedAssigner results).
               Launches must equal CT_LAUNCHES (26). Budget 20 s.
 36. yolo_trident — YOLOv3 D53 (its three configs' one model) 1 + 2
               calls at batch 1 and 2 on seeded batches at 320, 416 and 608
               (1 launch a call), 1 + 1 steps at batch 2 at 608 (none), the
               card against the CPU at 1x3x128x192; TridentNet R50-caffe
               (fc_cls x 100) at 800x1344: 1 + 2 calls at batch 1 and 2 (2
               launches a call), 1 + 1 steps at batch 2 (1 a step, the RPN
               and RoI head on the 3B branch-folded images), the card
               against the CPU at 1x3x128x192 on its branch-tiled gts and
               each branch's map, then the kernel alone on its training
               RPN's K = 12000 candidates at B = 1, 3 and 6. Launches must
               equal YT_LAUNCHES (32). Budget 30 s.
Every phase row carries `t`, the script's seconds so far; `--phases NAME
...` runs the named phases alone.
Then the `nvidia-smi` name/power-limit line, one JSON line of kernel figures
(the main path's case: dense-kept set, K = 1024, B = 1; `device_ms` is the
profiler's mask + sweep time; the `_k2048` keys the dense-kept set at
K = 2048, B = 1, the `_tta_merge` keys the first TTA image's own merge, the
`_k4819` keys the RPN's proposals at B = 1 (`_k4819_b2` at B = 2), the
`_k16800` keys the dense-kept set at K = 16800, B = 1, the
`_cascade_rpn_b2` / `_cascade_roi_b2` keys a batch-2 Cascade R-CNN call's
two NMS, the `_k6000` / `_k12000` keys (`_b2` at B = 2) the C4 RPN's test
and training candidates, the `_trident_k12000_b{1,3,6}` keys the trident
RPN's training candidates;
`launches` counts all main paths, `launches_<phase>` each), and last
`{"ok": true, "device": {...}}`. Any failed check raises, so the script exits
non-zero and prints no result; so does a host without CUDA.
"""
import contextlib
import json
import math
import os
import shutil
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
# K = 512 the GI path's, K = 2048 the TTA merge's (one image), K = 16800
# the exact GI mode's at stride 8 (the longest sweep checked)
TIME_CASES = ((512, 1), (1024, 1), (1024, 8), (2048, 1), (16800, 1))
VOC_CONFIG = 'configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py'
# the synthetic devkit: 07+12 trainval and 07 test, at VOC's 500x375 and
# 375x500 in turn
VOC_SPLITS = {'VOC2007': {'trainval': 6, 'test': 8},
              'VOC2012': {'trainval': 6}}
# --aug-scales of the TTA run: two scales, each with its flip
TTA_SCALES = (1000, 600, 1333, 800)
# the gfl_family phase's LD configs (each with its R101 teacher): (config,
# nms_keep launches a step, warm-up steps, timed steps, card-vs-CPU check)
FAMILY_LD = (('configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py', 5, 1, 2, True),
             ('configs/imv2/im_r50_gflv2_r101_1x.py', 5, 0, 1, False),
             ('configs/ld/ld_r50_atss_r101_1x.py', 0, 1, 2, True),
             ('configs/ld/ld_r50_fcos_r101_1x.py', 0, 1, 2, True),
             ('configs/ld/ld_retina_r50_1x.py', 0, 1, 2, True))
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
DCN_LD = (('configs/ld/ld_r101_gflv1_r101dcn_fpn_coco_2x.py', 1, 2),
          ('configs/ld/ld_x101_32x4d_dcn_self_2x_coco.py', 1, 1))
# the res2net phase: the GFLv2-Res2Net-101-DCN teacher served (warm-up and
# timed forward_test calls), its DCN layer count, and the IMv2 configs that
# distil it (config, warm-up steps, timed steps, student dtype, card vs CPU)
RES2NET_TEACHER = 'configs/imv2/gflv2_r2n101_dcn_fpn_2x.py'
RES2NET_SERVE_CALLS = (1, 2)
# at depth 50: 13 blocks in stages 2-4, 3 DCN splits each
RES2NET_DCN_LAYERS = 39
RES2NET_IM = (('configs/imv2/im_r101_gflv2_r2n101_dcn_2x.py', 1, 2, None,
               True),
              ('configs/imv2/im_gflv2_r2n101_dcn_self-2x.py', 1, 1,
               'bfloat16', False),
              ('configs/imv2/im_gflv2_x101-32x4dr2n101_dcn_2x.py', 1, 1, None,
               False))
# the classic_heads phase: the configs, and the warm-up and timed training
# steps of each
CLASSIC_CONFIGS = ('configs/retinanet/retinanet_r50_fpn_1x_coco.py',
                   'configs/fcos/fcos_r50_caffe_fpn_gn-head_1x_coco.py',
                   'configs/atss/atss_r50_fpn_1x_coco.py')
CLASSIC_STEPS = (1, 2)
# the two_stage phase: Faster R-CNN, the KD teacher, and the RPN's NMS K at
# 800x1344 (nms_pre 1000 on four levels, P6's 13 x 21 x 3 anchors)
FASTER_CONFIG = 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py'
KD_TEACHER_CONFIG = 'configs/faster_rcnn/faster_rcnn_r101_fpn_1x_coco.py'
RPN_K = 4 * 1000 + 13 * 21 * 3
# the mask_rcnn phase: Mask R-CNN R50, the X101-32x8d config with its own
# mask-loading pipeline, the instance data config whose train pipeline the
# R50 steps take, and the polygon set evaluated (images, sizes (h, w))
MASK_CONFIG = 'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py'
MASK_X101_CONFIG = 'configs/mask_rcnn/mask_rcnn_x101_32x8d_fpn_1x_coco.py'
MASK_DATA_CONFIG = 'configs/_base_/datasets/coco_instance.py'
MASK_EVAL_SET = (8, ((480, 640), (640, 480)))
# the cascade phase: (config, forward_test batch sizes, warm-up and timed
# training steps, card vs CPU) and its nms_keep launches, stated before the
# run: 2 a forward_test call (2 + 5 at each batch size), 1 a step, 2 an
# eval batch (Cascade Mask R-CNN's 8 images: 4 batches of 2)
CASCADE_CONFIGS = (
    ('configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py', (1, 2), (1, 2),
     False),
    ('configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py', (1, 2),
     (1, 2), True),
    ('configs/htc/htc_r50_fpn_1x_coco.py', (1, ), (1, 2), True))
CASCADE_LAUNCHES = sum(2 * 7 * len(b) + sum(s)
                       for _, b, s, _ in CASCADE_CONFIGS) + 2 * 4
# the hrnet_regnet phase: Faster R-CNN on the widest HRNet (W40), FCOS on
# HRNetV2p-W32 (HRFPN at stride 2), Mask R-CNN on RegNetX-3.2GF and its
# grouped-DCN (mdconv c3-c5) variant, RetinaNet on RegNetX-800MF; the
# (warm-up, timed) forward_test calls at each batch size and steps of each;
# one grouped-DCN conv2 of RegNetX-3.2GF's stage 3 (name, width, map at
# batch 2, conv groups)
HR_FASTER = 'configs/hrnet/faster_rcnn_hrnetv2p_w40_1x_coco.py'
HR_FCOS = 'configs/hrnet/fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py'
REG_MASK = 'configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py'
REG_MDCONV = ('configs/regnet/'
              'mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py')
REG_RETINA = 'configs/regnet/retinanet_regnetx-800MF_fpn_1x_coco.py'
HR_SERVE_CALLS, HR_BF16_CALLS, HR_STEPS = (1, 3), (1, 3), (1, 3)
HR_FCOS_CALLS, HR_FCOS_STEPS = (1, 5), (1, 2)
REG_SERVE_CALLS, REG_STEPS, REG_MDCONV_STEPS = (1, 3), (1, 3), (1, 2)
REG_RETINA_CALLS = (1, 5)
REG_DCN_LAYER = ('regnetx_3.2gf_stage3', 432, (50, 84), 9)
# its nms_keep launches, stated before the run: 2 a two-stage forward_test
# call (at batch 1 and 2; bf16 at batch 1), 1 a two-stage step, 1 a
# single-stage call, 0 a single-stage step
HRNET_REGNET_LAUNCHES = (
    2 * 2 * sum(HR_SERVE_CALLS) + 2 * sum(HR_BF16_CALLS) + sum(HR_STEPS) +
    sum(HR_FCOS_CALLS) + 2 * 2 * sum(REG_SERVE_CALLS) + sum(REG_STEPS) +
    sum(REG_MDCONV_STEPS) + sum(REG_RETINA_CALLS))
# its nms_keep launches, stated before the run: 1 a forward_test call, 5 a
# gibox step (one GI NMS per FPN level)
RES2NET_LAUNCHES = sum(RES2NET_SERVE_CALLS) + 5 * sum(
    w + t for _, w, t, _, _ in RES2NET_IM)
# the resnet_variants phase: Mask R-CNN R50 with GCNet blocks (r4, c3-c5),
# Faster R-CNN R50 with empirical attention '1111' (c4-c5), Faster R-CNN
# R50 with the 'DCN' type on c3-c5, Mask R-CNN R50 GN + WS, Cascade Mask
# R-CNN X101-32x4d with DCN and GCNet; (warm-up, timed) forward_test calls
# at batch 1 and 2 and steps at batch 2 of the first, second and fourth,
# calls at batch 1 of the DCN and cascade models; one c4 attention block
# (width, heads, kv stride, map, batch)
RV_GCB = 'configs/gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py'
RV_ATTENTION = ('configs/empirical_attention/'
                'faster_rcnn_r50_fpn_attention_1111_1x_coco.py')
RV_DCN = 'configs/dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py'
RV_GN_WS = 'configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py'
RV_CASCADE = ('configs/gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-'
              'backbone_dconv_c3-c5_r4_gcb_c3-c5_1x_coco.py')
RV_CALLS, RV_STEPS = (1, 3), (1, 3)
RV_DCN_CALLS, RV_CASCADE_CALLS = (1, 5), (1, 2)
RV_ATTENTION_LAYER = (256, 8, 2, (50, 84), 2)
# its nms_keep launches, stated before the run: 2 a two-stage (and cascade)
# forward_test call, 1 a two-stage step
RESNET_VARIANTS_LAUNCHES = (3 * 2 * 2 * sum(RV_CALLS) + 3 * sum(RV_STEPS) +
                            2 * sum(RV_DCN_CALLS) +
                            2 * sum(RV_CASCADE_CALLS))

# the data_host phase: the LVIS config over a seeded LVIS-v1 set of
# (images, sizes), (warm-up, timed) steps at batch 2 and forward_test calls
# at batch 1; the crop640 config's steps over a COCO set of its own; the
# host-cost image; the robustness tool's corruptions at one severity over a
# synthetic COCO set
LVIS_CONFIG = ('configs/lvis/'
               'mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py')
LVIS_SET = (8, ((480, 640), (427, 640), (640, 480), (640, 427)))
LVIS_STEPS, LVIS_CALLS = (1, 3), (1, 3)
CROP_CONFIG = 'configs/fpg/faster_rcnn_r50_fpn_crop640_50e_coco.py'
CROP_SET, CROP_STEPS = (4, ((800, 1000), (720, 960))), (1, 1)
HOST_COST_HW, HOST_COST_CALLS = (800, 1333), 5
ROBUST_CORRUPTIONS, ROBUST_SEVERITY = ('gaussian_noise', 'motion_blur'), 3
ROBUST_SET = (8, ((480, 640), (640, 480)))
# its nms_keep launches, stated before the run: 1 a two-stage step, 2 a
# two-stage call and eval batch (batch 2: LVIS_SET has 4 images of each
# orientation), 1 a single-stage eval batch (batch 4) in each of the
# robustness tool's runs
DATA_HOST_LAUNCHES = (sum(LVIS_STEPS) + 2 * sum(LVIS_CALLS) + 2 * 4 +
                      sum(CROP_STEPS) + (len(ROBUST_CORRUPTIONS) + 1) * 2)
# the vfnet phase: (warm-up, timed) forward_test calls at batch 1 and 2 and
# steps at batch 2 of the R50 config, calls at batch 1 of the widest
VFNET_CONFIG = 'configs/vfnet/vfnet_r50_fpn_1x_coco.py'
VFNET_WIDE = 'configs/vfnet/vfnet_x101_64x4d_fpn_mdconv_c3-c5_mstrain_2x_coco.py'
VFNET_CALLS, VFNET_CALLS_B2, VFNET_STEPS = (1, 5), (1, 3), (1, 3)
VFNET_WIDE_CALLS = (1, 3)
# 1 launch a forward_test call, none a step
VFNET_LAUNCHES = (sum(VFNET_CALLS) + sum(VFNET_CALLS_B2) +
                  sum(VFNET_WIDE_CALLS))
# the guided_anchoring phase: (warm-up, timed) forward_test calls of
# GA-RetinaNet R50 at batch 1 and 2 and its steps at batch 2, GA-Faster
# R-CNN R50's calls at batch 1 and steps at batch 2, GA-RPN R50's calls
GA_RETINA = 'configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py'
GA_FASTER = 'configs/guided_anchoring/ga_faster_r50_fpn_1x_coco.py'
GA_RPN = 'configs/guided_anchoring/ga_rpn_r50_fpn_1x_coco.py'
GA_CALLS, GA_CALLS_B2, GA_STEPS = (1, 3), (1, 2), (1, 2)
GA_FASTER_CALLS, GA_FASTER_STEPS, GA_RPN_CALLS = (1, 3), (1, 2), (1, 2)
# 1 launch a single-stage call (none a step), 2 a GA-Faster call (its
# GA-RPN's proposals and the RoI head's NMS), 1 a GA-Faster step (the
# proposals), 1 a GA-RPN call
GA_LAUNCHES = (sum(GA_CALLS) + sum(GA_CALLS_B2) + 2 * sum(GA_FASTER_CALLS) +
               sum(GA_FASTER_STEPS) + sum(GA_RPN_CALLS))
# the reppoints phase: the moment R50 config's calls at batch 1 and 2 and
# steps at batch 2, the grid config's calls and steps, the widest config's
# calls
RP_MOMENT = ('configs/reppoints/'
             'reppoints_moment_r50_fpn_gn-neck+head_1x_coco.py')
RP_GRID = 'configs/reppoints/bbox_r50_grid_center_fpn_gn-neck+head_1x_coco.py'
RP_WIDE = ('configs/reppoints/'
           'reppoints_moment_x101_fpn_dconv_c3-c5_gn-neck+head_2x_coco.py')
RP_CALLS, RP_CALLS_B2, RP_STEPS = (1, 3), (1, 2), (1, 2)
RP_GRID_CALLS, RP_GRID_STEPS, RP_WIDE_CALLS = (1, 2), (1, 1), (1, 2)
# 1 launch a call, none a step
RP_LAUNCHES = (sum(RP_CALLS) + sum(RP_CALLS_B2) + sum(RP_GRID_CALLS) +
               sum(RP_WIDE_CALLS))


# the fovea_ssd phase: (warm-up, timed) forward_test calls of FoveaBox R50
# at batch 1 and 2 and its steps at batch 2, FoveaBox-align R50's calls and
# steps and R101's calls; SSD300's calls at batch 1 and 8 and its steps at
# batch 8 (mmdet's SSD300 batch a GPU), SSD512's calls and steps
FOVEA = 'configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py'
FOVEA_ALIGN = 'configs/foveabox/fovea_align_r50_fpn_gn-head_4x4_2x_coco.py'
FOVEA_ALIGN_R101 = ('configs/foveabox/'
                    'fovea_align_r101_fpn_gn-head_4x4_2x_coco.py')
SSD300 = 'configs/ssd/ssd300_coco.py'
SSD512 = 'configs/ssd/ssd512_coco.py'
FOVEA_CALLS, FOVEA_CALLS_B2, FOVEA_STEPS = (1, 3), (1, 2), (1, 2)
ALIGN_CALLS, ALIGN_STEPS, ALIGN_R101_CALLS = (1, 3), (1, 2), (1, 2)
SSD300_CALLS, SSD300_CALLS_B8, SSD300_STEPS = (1, 5), (1, 3), (1, 3)
SSD512_CALLS, SSD512_STEPS = (1, 3), (1, 2)
# 1 launch a call (SSD's at K = 1024 of its 8732 or 24564 anchors x 80
# classes), none a step
FOVEA_SSD_LAUNCHES = sum(FOVEA_CALLS + FOVEA_CALLS_B2 + ALIGN_CALLS +
                         ALIGN_R101_CALLS + SSD300_CALLS + SSD300_CALLS_B8 +
                         SSD512_CALLS)
# the ms_rcnn_resnest phase: MS R-CNN R50's calls at batch 1 and 2 (with
# masks) and its steps at batch 2 (with loss_mask_iou), MS R-CNN X101's
# calls; the ResNeSt-50 Faster R-CNN's calls at batch 1 and 2 and its steps
# at batch 2 (its BNs live); the widest config, Cascade Mask R-CNN S101,
# its calls at batch 1 and its steps at batch 2
MS_RCNN = 'configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py'
MS_X101 = 'configs/ms_rcnn/ms_rcnn_x101_64x4d_fpn_1x_coco.py'
S50_FASTER = ('configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_'
              'mstrain-range_1x_coco.py')
S101_CASCADE = ('configs/resnest/cascade_mask_rcnn_s101_fpn_syncbn-'
                'backbone+head_mstrain_1x_coco.py')
MS_CALLS, MS_STEPS, MS_X101_CALLS = (1, 3), (1, 2), (1, 2)
S50_CALLS, S50_STEPS, S101_CALLS, S101_STEPS = (1, 3), (1, 2), (1, 2), (1, 2)
# 2 launches a two-stage call (the RPN's batch, the RoI head's or the last
# stage's NMS), 1 a step (the proposals)
MS_RESNEST_LAUNCHES = (2 * (2 * sum(MS_CALLS) + sum(MS_X101_CALLS) +
                            2 * sum(S50_CALLS) + sum(S101_CALLS)) +
                       sum(MS_STEPS) + sum(S50_STEPS) + sum(S101_STEPS))
# the paa_fsaf_freeanchor phase: PAA R50 (score voting on), FSAF R50 and
# FreeAnchor R50, each served at batch 1 and 2 and trained at batch 2
PAA = 'configs/paa/paa_r50_fpn_1x_coco.py'
FSAF = 'configs/fsaf/fsaf_r50_fpn_1x_coco.py'
FREE_ANCHOR = 'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py'
PFF_CALLS, PFF_CALLS_B2, PFF_STEPS = (1, 3), (1, 2), (1, 2)
# 1 launch a call, none a step
PAA_FSAF_FREEANCHOR_LAUNCHES = 3 * (sum(PFF_CALLS) + sum(PFF_CALLS_B2))
# the sabl phase: SABL RetinaNet R50 (plain and GN: the same net, caveat 57)
# served at batch 1 and 2 and trained at batch 2; SABL Faster R-CNN and
# SABL Cascade R-CNN R50 served at batch 1 and 2 and trained at batch 2
SABL_RETINA = 'configs/sabl/sabl_retinanet_r50_fpn_1x_coco.py'
SABL_RETINA_GN = 'configs/sabl/sabl_retinanet_r50_fpn_gn_1x_coco.py'
SABL_FASTER = 'configs/sabl/sabl_faster_rcnn_r50_fpn_1x_coco.py'
SABL_CASCADE = 'configs/sabl/sabl_cascade_rcnn_r50_fpn_1x_coco.py'
SABL_CALLS, SABL_CALLS_B2, SABL_STEPS = (1, 3), (1, 2), (1, 2)
SABL_ROI_CALLS, SABL_ROI_STEPS = (1, 2), (1, 2)
# 1 launch a single-stage call, none a single-stage step; 2 a two-stage
# call (the RPN's batch, the RoI head's), 1 a two-stage step
SABL_LAUNCHES = (2 * (sum(SABL_CALLS) + sum(SABL_CALLS_B2)) +
                 2 * (2 * 2 * sum(SABL_ROI_CALLS) + sum(SABL_ROI_STEPS)))

# the detectors_necks phase (budget 45 s): DetectoRS HTC R50 (SAC + RFP) and
# Cascade R-CNN R50 RFP at 800x1344; FPG Faster R-CNN and NAS-FPN RetinaNet
# at 640x640 (their sizes divide by 64 and 128); NAS-FCOS, CARAFE and PAFPN
# Faster R-CNN at 800x1344: (config, input size), each served at batch 1
# (warm-up, timed calls) and stepped at its config's samples_per_gpu
# (8 for FPG, 4 for NAS-FCOS, 2 for the rest), then held against the CPU
# at a small size; NAS-FPN's reference at 128x256, where its live head BNs
# see two values a channel on P7 and each merge cell's ratio is an integer
DN_MODELS = (
    ('configs/detectors/detectors_htc_r50_1x_coco.py', (800, 1344)),
    ('configs/detectors/cascade_rcnn_r50_rfp_1x_coco.py', (800, 1344)),
    ('configs/fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py', (640, 640)),
    ('configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py',
     (640, 640)),
    ('configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py',
     (800, 1344)),
    ('configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py', (800, 1344)),
    ('configs/pafpn/faster_rcnn_r50_pafpn_1x_coco.py', (800, 1344)))
DN_CALLS, DN_STEPS = (1, 2), (1, 2)
# the grid_point_rend phase (budget 15 s): Grid R-CNN and PointRend R50 at
# 800x1344, PointRend stepped with box-region gt masks (`loss_point`)
GP_MODELS = (('configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py',
              (800, 1344)),
             ('configs/point_rend/point_rend_r50_caffe_fpn_1x_coco.py',
              (800, 1344)))
# 1 launch a single-stage call, none a single-stage step; 2 a two-stage call
# (the RPN's batch, the RoI head's or the last stage's), 1 a two-stage step
DN_LAUNCHES = (5 * (2 * sum(DN_CALLS) + sum(DN_STEPS)) + 2 * sum(DN_CALLS))
GP_LAUNCHES = len(GP_MODELS) * (2 * sum(DN_CALLS) + sum(DN_STEPS))
# the libra_pisa phase (budget 40 s): Libra Faster R-CNN R50 (FPN + non-local
# BFP, CombinedSampler), Libra RetinaNet R50 (BalancedL1 at beta 0.11), PISA
# Faster and Mask R-CNN R50 (the Mask R-CNN stepped with box-region gt
# masks) and PISA RetinaNet R50 at 800x1344, as the detectors_necks models;
# PISA SSD300 served at batch 1 and stepped at mmdet's per-GPU 8
LP_MODELS = (
    ('configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py', (800, 1344)),
    ('configs/libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py', (800, 1344)),
    ('configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py', (800, 1344)),
    ('configs/pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py', (800, 1344)),
    ('configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py', (800, 1344)))
PISA_SSD = 'configs/pisa/pisa_ssd300_coco.py'
PISA_SSD_CALLS, PISA_SSD_STEPS = (1, 2), (1, 2)
LP_LAUNCHES = (3 * (2 * sum(DN_CALLS) + sum(DN_STEPS)) + 2 * sum(DN_CALLS) +
               sum(PISA_SSD_CALLS))
# the groie_mining phase (budget 30 s): GRoIE Faster, Mask and Grid R-CNN
# R50, and Faster R-CNN R50 with the OHEM sampler of
# configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py and with a
# ScoreHLRSampler (mmdet's PISA settings), each moved under
# roi_head.train_cfg (the config's top-level train_cfg is read by neither
# package, ROADMAP.md caveat 20); the two mining models' fc_cls peaked in
# their steps and references too, so that ScoreHLR's negatives pass its
# score_thr; then the sampler check
OHEM_CONFIG = 'configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py'
SCORE_HLR = dict(type='ScoreHLRSampler', num=512, pos_fraction=0.25,
                 neg_pos_ub=-1, add_gt_as_proposals=True, k=0.5, bias=0.,
                 score_thr=0.05, iou_thr=0.5)
# the samplers of the sampler check, at the configs' num 512
CHECK_SAMPLERS = dict(
    instance_balanced_pos=dict(type='InstanceBalancedPosSampler', num=512,
                               pos_fraction=0.25),
    iou_balanced_neg=dict(type='IoUBalancedNegSampler', num=512,
                          pos_fraction=0.25, floor_thr=-1, floor_fraction=0,
                          num_bins=3),
    iou_balanced_neg_floor=dict(type='IoUBalancedNegSampler', num=512,
                                pos_fraction=0.25, floor_thr=0.1,
                                floor_fraction=0.5, num_bins=3),
    combined=dict(type='CombinedSampler', num=512, pos_fraction=0.25,
                  pos_sampler=dict(type='InstanceBalancedPosSampler'),
                  neg_sampler=dict(type='IoUBalancedNegSampler',
                                   floor_thr=-1, floor_fraction=0,
                                   num_bins=3)),
    ohem=dict(type='OHEMSampler', num=512, pos_fraction=0.25),
    score_hlr=SCORE_HLR)


def ohem_sampler(cfg):
    """The OHEM config's `train_cfg.rcnn.sampler` under
    `model.roi_head.train_cfg`."""
    cfg.model.roi_head.train_cfg = dict(sampler=dict(
        cfg.train_cfg.rcnn.sampler))


def score_hlr_sampler(cfg):
    cfg.model.roi_head.train_cfg = dict(sampler=dict(SCORE_HLR))


GM_MODELS = (
    ('configs/groie/faster_rcnn_r50_fpn_groie_1x_coco.py', (800, 1344)),
    ('configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py', (800, 1344)),
    ('configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py',
     (800, 1344)),
    (OHEM_CONFIG, (800, 1344), ohem_sampler),
    (FASTER_CONFIG, (800, 1344), score_hlr_sampler))
GM_LAUNCHES = len(GM_MODELS) * (2 * sum(DN_CALLS) + sum(DN_STEPS))
# the loss a head adds, which its first step must have
HEAD_LOSS = dict(GridRoIHead='loss_grid', PointRendRoIHead='loss_point',
                 PISARoIHead='loss_carl', PISARetinaHead='loss_carl',
                 PISASSDHead='loss_carl', SCNetRoIHead='loss_glbctx')
# the roi_variants phase (budget 45 s): SCNet, Faster and Mask R-CNN C4
# (caffe), Faster R-CNN with deformable and modulated deformable RoI
# pooling, Double-Head and Dynamic R-CNN, all R50 at 800x1344: (config,
# box-region gt masks in its steps), each served at batch 1 and 2
# (warm-up, timed calls a batch), stepped at batch 2 (warm-up, timed) and
# held against the CPU at 128x192; the C4 RPN's NMS sizes (test_cfg.rpn's
# and train_cfg.rpn_proposal's nms_pre), timed alone
VAR_MODELS = (
    ('configs/scnet/scnet_r50_fpn_1x_coco.py', True),
    ('configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py', False),
    ('configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py', True),
    ('configs/dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py', False),
    ('configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py', False),
    ('configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py', False),
    ('configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py', False))
VAR_CALLS, VAR_STEPS = (1, 2), (1, 1)
C4_RPN_K = (6000, 12000)
# 2 launches a call (the RPN's batch, the RoI head's or the last stage's
# NMS) at batch 1 and 2, 1 a step (the proposals)
VAR_LAUNCHES = len(VAR_MODELS) * (2 * 2 * sum(VAR_CALLS) + sum(VAR_STEPS))
# the legacy_ghm phase (budget 15 s): RetinaNet R50 with the GHM losses
# stepped at batch 2; Faster R-CNN and RetinaNet R50 v1 (mmdet 1.x anchors
# and coder) served at batch 1 (warm-up, timed calls)
GHM_RETINA = 'configs/ghm/retinanet_ghm_r50_fpn_1x_coco.py'
V1_FASTER = 'configs/legacy_1.x/faster_rcnn_r50_fpn_1x_coco_v1.py'
V1_RETINA = 'configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py'
LG_CALLS, LG_STEPS = (1, 2), (1, 1)
# 2 launches a two-stage call, 1 a single-stage call, none a single-stage
# step
LG_LAUNCHES = 2 * sum(LG_CALLS) + sum(LG_CALLS)
# the crpn_tood phase (budget 20 s): the Cascade RPN Faster R-CNN and the
# Cascade RPN alone (R50-caffe) and TOOD R50 at 800x1344, each served at
# batch 1 and 2 (warm-up, timed calls a batch), stepped at batch 2 (warm-up,
# timed) and held against the CPU at 128x192, its assigners too
CRPN_FASTER = 'configs/cascade_rpn/crpn_faster_rcnn_r50_caffe_fpn_1x_coco.py'
CRPN_RPN = 'configs/cascade_rpn/crpn_r50_caffe_fpn_1x_coco.py'
TOOD_CONFIG = 'configs/tood/tood_r50_fpn_1x_coco.py'
CT_CALLS, CT_STEPS = (1, 2), (1, 1)
# the Faster R-CNN: 2 launches a call, 1 a step (its proposals); the RPN
# and TOOD: 1 a call, none a step
CT_LAUNCHES = 2 * 2 * sum(CT_CALLS) + sum(CT_STEPS) + 2 * 2 * sum(CT_CALLS)
# the yolo_trident phase (budget 30 s): YOLOv3 D53 served at 320, 416 and
# 608 (its three configs' model), at batch 1 and 2 on seeded batches at the
# config's square size, stepped at batch 2 at 608; TridentNet R50-caffe at
# 800x1344 served at batch 1 and 2, stepped at batch 2 (its predicted peak,
# PERF.md, well under 70 GB); each held against the CPU at 128x192; the
# trident RPN's training NMS (K = 12000 on the 3B branch-folded images)
# timed alone at B = 1, 3 and 6
YOLO_CONFIGS = ((320, 'configs/yolo/yolov3_d53_320_273e_coco.py'),
                (416, 'configs/yolo/yolov3_d53_mstrain-416_273e_coco.py'),
                (608, 'configs/yolo/yolov3_d53_mstrain-608_273e_coco.py'))
TRIDENT_CONFIG = 'configs/tridentnet/tridentnet_r50_caffe_1x_coco.py'
YT_CALLS, YT_STEPS = (1, 2), (1, 1)
TRIDENT_STEP_BATCH = 2
# YOLOv3: 1 launch a call, none a step; TridentNet: 2 a call, 1 a step
YT_LAUNCHES = (len(YOLO_CONFIGS) * 2 * sum(YT_CALLS) + 2 * 2 * sum(YT_CALLS)
               + sum(YT_STEPS))
# the depth the earlier phases run their 101-layer models at (widths kept):
# the dcn and res2net teachers and students, the X101 / S101 / R101 models
# of resnet_variants, vfnet, reppoints, fovea_ssd and ms_rcnn_resnest
DEPTH_CUT = 50


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row carries `t`, the script's seconds so
    far."""
    if 'phase' in obj:
        obj = dict(obj, t=time.perf_counter() - T_START)
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
    path's case (dense-kept set, K = 1024, B = 1), of K = 2048 and of
    K = 16800 (B = 1, the same set)."""
    from ld_tpu_torch.ops.nms_cuda import launch, nms_keep, nms_keep_ref
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
            # the kernel's launch without the operator's dispatch
            _, host_ms_launch = cuda_ms(lambda: launch(boxes, valid, 0.6),
                                        iters=200)
            dev = kernel_device_ms(torch, lambda: nms_keep(boxes, valid, 0.6),
                                   NMS_KERNELS)
            # the plain version holds K x K float matrices: fewer calls
            plain, _ = cuda_ms(lambda: nms_keep_ref(boxes, valid, 0.6),
                               iters=20 if k <= 2048 else 5,
                               warmup=3 if k <= 2048 else 1)
            bound, bound_by = nms_bound_ms(b, k)
            row.update(ms=ms, host_ms=host_ms, host_ms_launch=host_ms_launch,
                       dispatch_host_ms=host_ms - host_ms_launch,
                       device_ms=dev and sum(dev.values()),
                       **{f'device_ms_{n}': dev and dev[n]
                          for n in NMS_KERNELS},
                       plain_ms=plain, bound_ms=bound, bound_by=bound_by)
            emit(row)
            if (name, k, b) == ('dense_kept', 1024, 1):
                main_case = row
            if (name, k, b) == ('dense_kept', 2048, 1):
                tta_case = row
            if (name, k, b) == ('dense_kept', 16800, 1):
                k16800_case = row
            del boxes, valid
    return max_err, main_case, tta_case, k16800_case


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


def phase_profile(torch, model, bench, iters=1, phase='profile'):
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
                          phase='train_reference', dtype=None,
                          hw=(128, 192)):
    """The first step on 1x3x`hw` (128x192) on the card against the same
    model on the CPU, within the tolerances of `REFERENCE_TOL[dtype]`: the
    loss dict
    term by term, with bf16 towers the head outputs too, and (with `gi`)
    the GI masks of that step, identical in float32."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    tol = REFERENCE_TOL[dtype]
    rtol = tol['rtol']
    runs = {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(base).to(device)
        batch = detection_batch(1, *hw, seed=0, device=device)
        step, _ = make_step(cfg, model)
        masks, gaps, heads = [], [], []
        with torch.no_grad():
            outs = model(batch['image'])
            heads = [x.cpu() for x in flat_tensors(outs)]
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
               input='1x3x{}x{}'.format(*hw), dtype=dtype or 'float32',
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


def phase_train(torch, smi, warmup=2, timed=3, batch_size=2,
                pad=(800, 1344)):
    """The GI config's LD training step at full width on the card; returns
    the kernel's launch count over the main path's steps."""
    return ld_steps(torch, smi, TRAIN_CONFIG, 5, warmup, timed,
                    batch_size=batch_size, pad=pad, phase='train')[0]


def ld_steps(torch, smi, config, per_step, warmup, timed, reference=True,
             batch_size=2, pad=(800, 1344), phase='gfl_family', dtype=None,
             cpu_check=True, student_offsets=True, prof_steps=1):
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


@contextlib.contextmanager
def module_ranges(model, cls, name):
    """A torch.profiler `record_function` range named `name` around the
    forward of every `cls` module of `model` while in the block; yields
    the number of such modules."""
    from torch.profiler import record_function
    opened = []

    def enter(module, args):
        opened.append(record_function(name))
        opened[-1].__enter__()

    def leave(module, args, out):
        opened.pop().__exit__(None, None, None)
    modules = [m for m in model.modules() if isinstance(m, cls)]
    hooks = [h for m in modules for h in (m.register_forward_pre_hook(enter),
                                          m.register_forward_hook(leave))]
    try:
        yield len(modules)
    finally:
        for h in hooks:
            h.remove()


def step_profile(torch, step, batch, prof_steps=1, top_n=10, ranges=None):
    """Device time of `prof_steps` steps by kernel, from torch.profiler:
    device ms a step against its wall ms (the busy share), device ops a
    step, the GI NMS kernels' ms a step and the top kernels; with `ranges`
    (the name of `module_ranges` set around the steps), the device ms a
    step of the kernels those ranges launch (the forward's) and their
    share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(prof_steps):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda and e.key != ranges]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return dict(device_time='not measured')
    nms_us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in NMS_KERNELS))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    extra = {}
    if ranges is not None:
        range_us = sum(e.device_time_total for e in events
                       if e.key == ranges and e.device_type != cuda)
        extra = {f'{ranges}_device_ms_per_step': range_us / prof_steps / 1e3
                 if range_us > 0 else 'not measured',
                 f'{ranges}_device_share': range_us / total_us
                 if range_us > 0 else 'not measured'}
    return dict(**extra,
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
    img_ids, loss dict, nms_keep launches and end time go to `record`, and
    after the `preempt_after`-th step of this run SIGTERM is raised in the
    main thread, as a preempting scheduler would send it."""
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
                               losses={k: float(v) for k, v in out.items()},
                               t=time.perf_counter()))
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
    spec = importlib.util.spec_from_file_location(
        'tool_' + name.replace('/', '_'), path)
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
    from ld_tpu_torch.models.heads import ATSSGFLHead
    from ld_tpu_torch.models.heads.gfl_head import flatten_level
    if type(head).__name__ == 'GFocalHead':
        probs = outs[0]
    elif type(head).__name__ == 'PAAHead':
        probs = [torch.sqrt(torch.sigmoid(c) * torch.sigmoid(r))
                 for c, r in zip(outs[0], outs[2])]
    elif type(head).__name__ == 'SABLRetinaHead':
        # a score is the class sigmoid times the bucket confidence, over the
        # per-level top-k by the sigmoid
        best = 0.0
        nms_pre = head.test_cfg.get('nms_pre', 1000)
        for c, bc, br in zip(*outs):
            p = torch.sigmoid(flatten_level(c))[0]
            bc, br = flatten_level(bc)[0], flatten_level(br)[0]
            conf = head.coder.decode(torch.zeros_like(bc[:, :4]),
                                     (bc, br))[1]
            top = torch.topk(p.amax(-1), min(nms_pre, p.shape[0])).indices
            best = max(best, float((p[top] * conf[top, None]).max()))
        return best
    elif isinstance(head, ATSSGFLHead):   # ATSS / FCOS, GFL and plain
        probs = [torch.sigmoid(c) * torch.sigmoid(r)
                 for c, r in zip(outs[0], outs[2])]
    else:
        probs = [torch.sigmoid(c) for c in outs[0]]
    return max(float(p.max()) for p in probs)


def family_serve(torch, smi, config, depth=None, warmup=2, timed=10,
                 hw=(800, 1344), phase='gfl_family_serve', extra=None,
                 prepare=None):
    """`forward_test` of a GFL-family config at 800x1344, batch 1, at full
    width (random weights from seed 0, DCN offsets too, the cls prediction
    bias 0 so that NMS sees candidates); 1 nms_keep launch a call, the
    detections bit-identical with the plain keep mask, and the first
    detection's score the largest class probability (no second sigmoid on
    probabilities). `prepare(model)` seeds more of the model before it goes
    to the card; `extra(model, bench)` adds figures to the row. Returns
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
    if prepare is not None:
        prepare(model)
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
               depth=cfg.model.backbone.get('depth'),
               head=type(head).__name__,
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
    """The other GFL-family heads at full width: LDv2 (1 + 2 steps), IMv2
    (1 step), LD on ATSS-, FCOS- and Retina-GFL (1 + 2 steps each), then
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
    CPU; 1 + 3 steps of the R101-DCN -> R101 LD config and 1 + 2 of the
    X101-DCN self-LD one (no launch, card vs CPU at 1x3x128x192); one bf16
    step of each. Returns the kernel's launch count over the main paths."""
    launches = 0
    for config in DCN_SERVE:
        def extra(model, bench, voting='r101' in config):
            out = dcn_device_share(
                torch, model, lambda: model.forward_test(bench), iters=1)
            if voting:
                out.update(voting_serve(torch, model, bench, 1, 3))
            out.update(teacher_forward(torch, model, iters=1))
            return out
        n, row = family_serve(torch, smi, config, DEPTH_CUT, warmup=1,
                              timed=3, phase='dcn_serve', extra=extra)
        # at depth 50: R50-DCN c3-c5 13 layers, X50-DCN c4-c5 9
        check(row['dcn_layers'] == (13 if 'r101' in config else 9),
              f'{config}: {row["dcn_layers"]} DCN layers')
        launches += n
    layers = [dcn_layer_check(torch, *spec) for spec in DCN_LAYERS]
    emit(dict(phase='dcn_layers', nvidia_smi=smi, layers=layers))
    for config, warmup, timed in DCN_LD:
        n, row = ld_steps(torch, smi, depth_config(config), 0, warmup,
                          timed, phase='dcn_train', prof_steps=1)
        check(row['dcn_layers_teacher'] > 0, f'{config}: no DCN teacher')
        launches += n
    for config, _, _ in DCN_LD:
        launches += ld_steps(torch, smi, depth_config(config), 0, 1, 1,
                             reference=False, phase='dcn_bf16',
                             dtype='bfloat16')[0]
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
    distil it, 5 launches a gibox step: the R101 student (1 + 3 steps,
    float32, its profile and the card vs the CPU at 1x3x128x192), the
    R2N101-DCN self student in its config's bf16 (1 + 2) and the
    X101-32x4d student (1 + 1). A
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
    launches, row = family_serve(torch, smi, RES2NET_TEACHER, DEPTH_CUT,
                                 warmup=warmup, timed=timed,
                                 phase='res2net_serve', extra=extra)
    check(row['backbone'] == 'Res2Net' and
          row['dcn_layers'] == RES2NET_DCN_LAYERS,
          f'{RES2NET_TEACHER}: {row["backbone"]} with {row["dcn_layers"]} '
          'DCN layers')
    teacher_reference(torch, np, depth_config(RES2NET_TEACHER))
    for config, warmup, timed, dtype, cpu_check in RES2NET_IM:
        config = depth_config(config)
        # the teacher's ms and a step's profile with the card-vs-CPU
        # check only: the profiler's post-processing of a Res2Net-DCN
        # student's step (~40k device ops) takes tens of seconds
        n, row = ld_steps(torch, smi, config, 5, warmup, timed,
                          reference=cpu_check, phase='res2net_train',
                          dtype=dtype, student_offsets=False, prof_steps=1)
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


DDP_STEP = (1, 2)


def ddp_step_inputs():
    """(a)'s config and global batch: the GI config, 2 images a rank of
    testing.detection_batch at 800x1344."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.testing import detection_batch_np
    return (Config.fromfile(os.path.join(ROOT, TRAIN_CONFIG)),
            detection_batch_np(2 * DDP_RANKS, 800, 1344, seed=0))


def ddp_step(torch, np, work, warmup=DDP_STEP[0], timed=DDP_STEP[1]):
    """(a) The GI config's step at full width, float32, over the 2 ranks of
    the phase's torchrun launch (`--ddp-step-worker`, the launch's first
    job) x 2 images of testing.detection_batch at 800x1344, against one
    process at 4 images over the same images and weights: each loss term
    within rtol 1e-3, the GI masks identical, the parameters after the
    step within 1e-5 of their largest value, 5 launches a step a rank.
    Returns the ranks' launches and the figures."""
    from ld_tpu_torch.testing import ld_step_rank
    cfg, batch = ddp_step_inputs()
    steps = warmup + timed
    # each rank counted its launches from 0 (the worker's job)
    ranks = ddp_read(torch, os.path.join(work, 'step'))
    torch.cuda.empty_cache()
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
    """torchrun's target in the ddp phase, one rank: jobs separated by
    `--ddp-job`, each `MODE OUT PREEMPT -- ARGS`, run in turn in this
    process (a torchrun launch and its ranks' start-up take ~30 s, so one
    launch runs every job).
    `--ddp-train-worker` runs tools/train.py's main on ARGS, recording this
    rank's img_ids, losses and launches a step (the `make_train_step` of
    train_detector wrapped; rank 0 raises SIGTERM after its step PREEMPT
    unless it is 0) and the checkpoints its work dir holds at the end;
    `--ddp-test-worker` runs tools/test.py's main; `--ddp-step-worker`
    runs `testing.ld_step_rank` on the ddp phase's (a) inputs
    (`ddp_step_inputs`) and writes its result. Each job writes
    OUT.rank<r>.pt."""
    import torch
    sys.path.insert(0, ROOT)
    import ld_tpu_torch.apis.train as train_api
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    # as the phases of this process: float32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist
    from ld_tpu_torch.parallel.dist import init_dist
    rank = int(os.environ['RANK'])
    jobs = [[]]
    for a in argv:
        if a == '--ddp-job':
            jobs.append([])
        else:
            jobs[-1].append(a)
    # the process group, joined once for every job (the tools keep a group
    # that is up; a second join in one process can hang the rendezvous)
    first = jobs[0][4:]
    init_dist('pytorch', next(a.split('=', 1)[1] for a in first
                              if a.startswith('dist_params.backend=')),
              device=first[first.index('--device') + 1]
              if '--device' in first else None)
    for mode, out, preempt, _, *args in jobs:
        preempt = int(preempt)
        nms_keep.launches = 0
        torch.cuda.reset_peak_memory_stats()
        record = []
        if mode == '--ddp-step-worker':
            from ld_tpu_torch.testing import ld_step_rank
            torch.save(ld_step_rank(rank, DDP_RANKS, 'cuda',
                                    *ddp_step_inputs(), sum(DDP_STEP),
                                    True), f'{out}.rank{rank}.pt')
            continue
        if mode == '--ddp-train-worker':
            instrument_steps(train_api, record,
                             preempt_after=preempt if rank == 0 and preempt
                             else None)
            ret = load_tool('train').main(args)
            work_dir = args[args.index('--work-dir') + 1]
            res = dict(preempted=ret['preempted'], step=ret['step'],
                       checkpoints=sorted(os.listdir(os.path.join(
                           work_dir, 'checkpoints'))))
        else:
            res = dict(results=load_tool('test').main(args)['results'])
        torch.save(dict(res, record=record, launches=nms_keep.launches,
                        peak_bytes=torch.cuda.max_memory_allocated()),
                   f'{out}.rank{rank}.pt')
    dist.destroy_process_group()
    return 0


def ddp_read(torch, out):
    return [torch.load(f'{out}.rank{r}.pt', weights_only=False)
            for r in range(DDP_RANKS)]


def ddp_cli(torch, np, work, steps_per_epoch=3, epochs=2):
    """One torchrun launch of 2 ranks: first (a)'s step job (`ddp_step`
    reads it), then
    (b) tools/train.py --launcher pytorch over 2 ranks with the runtime
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
    ckpt = os.path.join(work, 'through', 'checkpoints', f'{steps}.pth')

    def train_job(name, preempt, wd, *extra):
        return ['--ddp-train-worker', os.path.join(work, name), preempt,
                '--', cfg_path, '--work-dir', wd, '--launcher', 'pytorch',
                *opts, *extra]
    # one launch (its ranks' start-up costs tens of seconds): (a)'s step,
    # the run through, the run preempted, its resumption, and (c) the test
    # CLI on the first run's checkpoint, in turn in each rank's process
    args = ['--ddp-step-worker', os.path.join(work, 'step'), 0, '--',
            *opts[1:], '--ddp-job',
            *train_job('through', 0, os.path.join(work, 'through')),
            '--ddp-job',
            *train_job('preempted', 3, os.path.join(work, 'cut')),
            '--ddp-job',
            *train_job('resumed', 0, os.path.join(work, 'cut'),
                       '--resume-from', os.path.join(work, 'cut')),
            '--ddp-job', '--ddp-test-worker', os.path.join(work, 'test'),
            0, '--', cfg_path, ckpt, '--eval', 'bbox', '--launcher',
            'pytorch', *opts]
    runs = {}
    t0 = time.perf_counter()
    torchrun(args)
    seconds = dict(launch=time.perf_counter() - t0)
    for name in ('through', 'preempted', 'resumed'):
        runs[name] = ddp_read(torch, os.path.join(work, name))
    through, cut = runs['through'], runs['preempted']
    ckpts_at_preemption = cut[0]['checkpoints']
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
    check(sorted(os.listdir(os.path.join(work, 'through', 'checkpoints')))
          == [f'{steps}.pth'] and os.path.exists(os.path.join(
              work, 'through', 'best_bbox_mAP.pth')),
          'ddp cli: checkpoints')
    model = build_detector(cfg.model)
    load_checkpoint(model, ckpt)

    # (c) the test CLI on the checkpoint
    tests = ddp_read(torch, os.path.join(work, 'test'))
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
    over 2 ranks, all in one torchrun launch (its ranks' start-up paid
    once), (d) their figures beside the card's name and power limit. On one card the ranks share it over gloo: these figures are the
    collective path's cost there, not a scaling figure. Returns the
    kernel's launches over the ranks' main paths."""
    import shutil
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_ddp')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    cli_launches, cli_row = ddp_cli(torch, np, work)
    step_launches, step_row = ddp_step(torch, np, work)
    emit(dict(phase='ddp', config=TRAIN_CONFIG, nvidia_smi=smi,
              launches=step_launches + cli_launches, **step_row, **cli_row,
              seconds=time.perf_counter() - t0))
    shutil.rmtree(work, ignore_errors=True)
    return step_launches + cli_launches


# the harness phase: ld_gain_experiment's schedule cut to (teacher epochs,
# student epochs) over its own 96 + 32 images
HARNESS_EPOCHS = (2, 1)
# the serve_http phase: concurrent requests, the server's largest batch
SERVE_REQUESTS = 12
SERVE_MAX_BATCH = 4
FULL_HW = (800, 1344)
# run_export.py's main in a fresh interpreter with TF32 off, as here, then
# the NMS kernel's launch count there and the framework modules it loaded
RUN_EXPORT_CHILD = (
    "import json, runpy, sys, torch; "
    "torch.backends.cudnn.allow_tf32 = False; "
    "torch.backends.cuda.matmul.allow_tf32 = False; "
    "sys.argv = ['run_export.py', *sys.argv[1:]]; "
    "runpy.run_path({path!r}, run_name='__main__'); "
    "nms = sys.modules['ld_tpu_torch.ops.nms_cuda']; "
    "print(json.dumps(dict(launches=nms.nms_keep.launches, modules=sorted("
    "m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'flax', 'ld_tpu', 'ld_tpu_torch')))))")


def scaled_diff(np, got, want):
    """The largest |got - want| over max(|want|, 1): absolute below 1,
    relative above, so that box coordinates past 1024 px, whose float32
    spacing is 1.22e-4, are held to their own precision."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def same_detections(np, got, want):
    """Two lists of detection records (JSON, score order): the same labels
    in the same order and every box and score within 1e-4 by
    `scaled_diff`."""
    return (len(got) == len(want) and
            [g['label'] for g in got] == [w['label'] for w in want] and
            (not got or scaled_diff(np, [g['bbox'] + [g['score']]
                                         for g in got],
                                    [w['bbox'] + [w['score']]
                                     for w in want]) <= 1e-4))


def phase_harness(torch, smi, epochs=HARNESS_EPOCHS):
    """The port's ld_gain_experiment on its own data at a cut schedule:
    teacher, baseline and LD students through `main`, then the zero-weight
    LD student against the baseline step by step. cuDNN runs its
    deterministic algorithms here, so that the two runs are comparable at
    all (losses within rtol 1e-5; its wgrad is not bitwise deterministic
    otherwise). Every loss finite, no launch a step, 1 an eval batch.
    Returns (launches, work dir, row)."""
    from ld_tpu_torch.apis import train as train_api
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.tools.analysis_tools import ld_gain_experiment as gain

    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_harness')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    make_train_step = train_api.make_train_step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    record = []
    instrument_steps(train_api, record)
    t0 = time.perf_counter()
    try:
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        summary = gain.main([
            '--teacher-epochs', str(epochs[0]), '--student-epochs',
            str(epochs[1]), '--work-dir', work,
            '--out', os.path.join(work, 'ld_gain.json')])
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        seconds = time.perf_counter() - t0
        runs = len(record)
        train, val = gain.datasets()
        zcfg = gain.ld_student_cfg(
            epochs[1], gain.base_cfg(epochs[0])['model'],
            os.path.join(work, 'teacher.pth'), ld=0.0, vlr=0.0, kd=0.0)
        train_api.train_detector(zcfg, os.path.join(work, 'student_zero'),
                                 dataset=train, device='cuda')
    finally:
        train_api.make_train_step = make_train_step
        torch.backends.cudnn.deterministic = deterministic
    steps_t = epochs[0] * len(train) // 2
    steps_s = epochs[1] * len(train) // 2
    check(runs == steps_t + 2 * steps_s and
          len(record) == steps_t + 3 * steps_s,
          f'harness ran {len(record)} steps, expected '
          f'{steps_t} + 3 x {steps_s}')
    teacher, base = record[:steps_t], record[steps_t:steps_t + steps_s]
    ld, zero = record[steps_t + steps_s:runs], record[runs:]
    check(all(math.isfinite(v) for r in record for v in r['losses'].values()),
          'harness: a non-finite loss')
    check(all(r['launches'] == 0 for r in record),
          'harness: an nms_keep launch in a training step')
    eval_batches = 3 * math.ceil(len(val) / 4)
    check(launches == eval_batches,
          f'harness: nms_keep launched {launches} times for {eval_batches} '
          'eval batches')
    worst = 0.0
    for b, z in zip(base, zero):
        for k, v in b['losses'].items():
            worst = max(worst, abs(z['losses'][k] - v) / max(abs(v), 1e-12))
        check(all(z['losses'][k] == 0.0
                  for k in ('loss_ld', 'loss_ld_vlr', 'loss_kd')),
              'harness: a zero-weight LD term is not 0')
    check(worst <= 1e-5, f'harness: the zero-weight LD student differs from '
          f'the baseline by rtol {worst}')
    for name, run in (('teacher', teacher), ('baseline', base), ('ld', ld)):
        check(all(r['losses']['loss'] > 0 for r in run),
              f'harness: {name} loss not positive')

    def steps_per_s(run):
        return (len(run) - 1) / (run[-1]['t'] - run[0]['t'])
    row = dict(phase='harness', nvidia_smi=smi,
               tool='ld_tpu_torch/tools/analysis_tools/ld_gain_experiment.py',
               teacher_epochs=epochs[0], student_epochs=epochs[1],
               train_images=len(train), val_images=len(val),
               cudnn_deterministic=True,
               teacher_mAP=summary['teacher']['bbox_mAP'],
               baseline_mAP=summary['baseline_student']['bbox_mAP'],
               ld_mAP=summary['ld_student']['bbox_mAP'],
               ld_gain_mAP=summary['ld_gain_mAP'],
               steps=dict(teacher=len(teacher), baseline=len(base),
                          ld=len(ld), zero=len(zero)),
               steps_per_s=dict(teacher=steps_per_s(teacher),
                                baseline=steps_per_s(base),
                                ld=steps_per_s(ld),
                                zero=steps_per_s(zero)),
               first_loss=dict(teacher=teacher[0]['losses']['loss'],
                               ld=ld[0]['losses']['loss']),
               last_loss=dict(teacher=teacher[-1]['losses']['loss'],
                              baseline=base[-1]['losses']['loss'],
                              ld=ld[-1]['losses']['loss']),
               zero_vs_baseline_max_rel_diff=worst,
               nms_keep_launches=launches, eval_batches=eval_batches,
               main_seconds=seconds)
    emit(row)
    return launches, work, row


def phase_landscape(torch, smi, work, epochs=HARNESS_EPOCHS):
    """ap_landscape on the harness's teacher and LD student (configs
    dumped beside their checkpoints, the held-out split as the test set):
    every statistic finite, Pearson in [-1, 1]; no NMS, so no launch.
    Returns the launches."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.tools.analysis_tools import ap_landscape
    from ld_tpu_torch.tools.analysis_tools import ld_gain_experiment as gain
    from ld_tpu_torch.utils.checkpoint import latest_checkpoint
    test = dict(type='SyntheticDetectionDataset', num_images=32, hw=gain.HW,
                num_classes=gain.NUM_CLASSES, max_boxes=4, seed=1,
                draw_boxes=True,
                pipeline=gain.PIPE[:-1] + [dict(type='Collect',
                                                keys=['img'])])
    paths = []
    for name, cfg, run in (('teacher', gain.base_cfg(epochs[0]), 'teacher'),
                           ('student_ld', gain.student_cfg(epochs[1]),
                            'student_ld')):
        cfg['data']['test'] = dict(test)
        path = os.path.join(work, f'{name}_config.py')
        cfg.dump(path)
        paths += [path, latest_checkpoint(os.path.join(work, run))]
    out = os.path.join(work, 'ap_landscape.json')
    t0 = time.perf_counter()
    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    res = ap_landscape.main([paths[0], paths[2], '--checkpoint1', paths[1],
                             '--checkpoint2', paths[3], '--max-images', '32',
                             '--out', out])
    torch.cuda.synchronize()
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    seconds = time.perf_counter() - t0
    per = res['per_batch']
    check(len(per['pearson']) == 32, 'landscape: batches')
    check(all(math.isfinite(v) for k in ('feat_l1', 'cls_l1', 'bbox_l1')
              for b in per[k] for v in b) and
          all(math.isfinite(p) and -1.0 <= p <= 1.0
              for p in per['pearson']),
          'landscape: a statistic not finite, or Pearson outside [-1, 1]')
    check(launches == 0, f'landscape: {launches} nms_keep launches')
    emit(dict(phase='landscape', nvidia_smi=smi,
              tool='ld_tpu_torch/tools/analysis_tools/ap_landscape.py',
              images=32, summary=res['summary'], seconds=seconds,
              nms_keep_launches=launches))
    return launches


def jpeg_requests(np, count, seed=0):
    """`count` seeded JPEG images of the e2e phase's request sizes, with
    coloured rectangles on noise."""
    from PIL import Image
    import io
    rng = np.random.RandomState(seed)
    sizes = [(480, 640), (640, 480), (800, 1333), (600, 800), (800, 600),
             (427, 640), (1024, 768), (375, 500)]
    out = []
    for i in range(count):
        hw = sizes[i % len(sizes)]
        img = rng.randint(0, 96, hw + (3, )).astype(np.uint8)
        for _ in range(4):
            y, x = rng.randint(0, hw[0] // 2), rng.randint(0, hw[1] // 2)
            img[y:y + hw[0] // 3, x:x + hw[1] // 3] = rng.randint(96, 256, 3)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format='JPEG', quality=90)
        out.append((hw, buf.getvalue()))
    return out


def gfl_r50_checkpoint(torch, work):
    """The e2e phase's GFL-R50 (float32, seed 0, gfl_cls bias 0) written to
    a `.pth` under `work`; returns its path."""
    from ld_tpu_torch.apis import init_detector
    model = init_detector(float32_cfg(CONFIG), device='cpu', seed=0)
    with torch.no_grad():
        model.bbox_head.gfl_cls.bias.zero_()
    path = os.path.join(work, 'gfl_r50_seed0.pth')
    torch.save(dict(state_dict=model.state_dict()), path)
    return path


def phase_serve_http(torch, np, smi, work):
    """serve.py's server on GFL-R50 at 800x1344 on the card (max batch 4,
    the default 4 ms window) answering SERVE_REQUESTS concurrent seeded
    JPEGs: every reply 200; every batch formed (its members from the
    replies' `X-Batch` headers) run again through the same preprocessing
    and `infer` gives each member's reply (`same_detections`); each
    image's head outputs at batch 1 within 1e-4 of its slot in that batch
    (`scaled_diff`); one launch a batch formed. Whether each reply also
    equals the image's batch-1 detections is counted, not required: on the
    card batch 4 and batch 1 differ by float32 noise, and among random
    weights' near-equal scores that reorders NMS candidates. Returns the
    launches and the checkpoint."""
    import threading
    import urllib.request
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.tools.deployment import serve

    ckpt = gfl_r50_checkpoint(torch, work)
    t0 = time.perf_counter()
    server = serve.make_server(float32_cfg(CONFIG), ckpt, FULL_HW,
                               max_batch=SERVE_MAX_BATCH, port=0,
                               device='cuda')
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    requests = jpeg_requests(np, SERVE_REQUESTS)
    replies = [None] * len(requests)
    latency = [None] * len(requests)
    start = threading.Barrier(len(requests))

    def client(i):
        req = urllib.request.Request(f'http://127.0.0.1:{port}/predict',
                                     data=requests[i][1], method='POST')
        start.wait()
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            replies[i] = (resp.status, json.loads(resp.read()),
                          tuple(map(int, resp.headers['X-Batch'].split())))
        latency[i] = (time.perf_counter() - t) * 1e3
    try:
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        t_all = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, ))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_all = time.perf_counter() - t_all
        launches = nms_keep.launches
        # ------------------------------------------------------------------
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    formed = list(server.batcher.formed)
    check(all(r is not None and r[0] == 200 for r in replies),
          f'serve_http: replies {[r and r[0] for r in replies]}')
    check(sum(formed) == len(requests) and launches == len(formed),
          f'serve_http: {launches} nms_keep launches for the batches '
          f'{formed}')
    # the host pipeline alone, then each batch formed run again
    pre_ms, inputs = [], []
    for _, data in requests:
        t = time.perf_counter()
        inputs.append(serve.preprocess(data, FULL_HW))
        pre_ms.append((time.perf_counter() - t) * 1e3)
    worst_net, same_as_batch1, n_dets = 0.0, 0, []
    for index, count in enumerate(formed):
        members = sorted((r[2][1], i) for i, r in enumerate(replies)
                         if r[2][0] == index)
        size = replies[members[0][1]][2][2]
        check([slot for slot, _ in members] == list(range(count)) and
              size >= count, f'serve_http: batch {index}: {members}')
        images = np.zeros((size, *FULL_HW, 3), np.float32)
        hws = np.ones((size, 2), np.float32)
        for slot, i in members:
            images[slot], hws[slot] = inputs[i][0], inputs[i][1]
        dets, labels, _ = server.infer(images, hws)
        with torch.inference_mode():
            batch_outs = server.model(torch.from_numpy(images).cuda()
                                      .permute(0, 3, 1, 2).contiguous())
        for slot, i in members:
            scale = inputs[i][2]
            got = replies[i][1]['detections']
            check(same_detections(np, got, serve.detections(
                dets[slot], labels[slot], scale, 0.3)),
                  f'serve_http: request {i} differs from its batch run again')
            single = images[slot:slot + 1]
            with torch.inference_mode():
                outs = server.model(torch.from_numpy(single).cuda()
                                    .permute(0, 3, 1, 2).contiguous())
            for part, batch_part in zip(outs, batch_outs):
                for lvl, batch_lvl in zip(part, batch_part):
                    worst_net = max(worst_net, scaled_diff(
                        np, lvl[0].cpu().numpy(),
                        batch_lvl[slot].cpu().numpy()))
            d1, l1, _ = server.infer(single, hws[slot:slot + 1])
            same_as_batch1 += same_detections(np, got, serve.detections(
                d1[0], l1[0], scale, 0.3))
            n_dets.append(len(got))
    check(worst_net <= 1e-4, f'serve_http: head outputs at batch 1 differ '
          f'from the batch by {worst_net}')
    check(min(n_dets) > 0, 'serve_http: a reply without detections')
    lat = sorted(latency)
    row = dict(phase='serve_http', nvidia_smi=smi, config=CONFIG,
               tool='ld_tpu_torch/tools/deployment/serve.py',
               requests=len(requests), request_sizes=[r[0] for r in requests],
               max_batch=SERVE_MAX_BATCH, window_ms=4.0,
               batches_formed=formed, batch_infer_ms=server.batcher.infer_ms,
               warm_seconds=warm_s,
               latency_ms=latency,
               latency_ms_p50=float(np.percentile(lat, 50)),
               latency_ms_p90=float(np.percentile(lat, 90)),
               wall_s=t_all, img_per_s=len(requests) / t_all,
               preprocess_ms=pre_ms,
               preprocess_ms_mean=sum(pre_ms) / len(pre_ms),
               host_pipeline_share=sum(pre_ms) / sum(latency),
               detections=n_dets, head_outputs_vs_batch1=worst_net,
               replies_equal_to_batch1=same_as_batch1,
               nms_keep_launches=launches)
    emit(row)
    return launches, ckpt


def phase_export(torch, np, smi, work, ckpt):
    """export.py's export of GFL-R50 at 1x3x800x1344 on the card (the NMS
    one `ld_tpu_torch::nms_keep` node), the exported program's forward_test
    ms against eager, run_export.py in a fresh interpreter (its detections
    eager forward_test's by `same_detections`, 1 launch a call counted
    there, no module of jax, flax or ld_tpu and of ld_tpu_torch only the
    operator's), and one call's keep mask from the kernel identical with
    nms_keep_ref. Returns the launches (this process's and the child's)."""
    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    from ld_tpu_torch.tools.deployment import export

    model = init_detector(float32_cfg(CONFIG), ckpt, device='cuda')
    t0 = time.perf_counter()
    exported = export.export_detector(model, FULL_HW)
    export_s = time.perf_counter() - t0
    check(len(export.nms_nodes(exported)) == 1,
          'export: the graph does not hold one ld_tpu_torch::nms_keep node')
    path = os.path.join(work, 'gfl_r50.pt2')
    torch.export.save(exported, path)
    inputs, outputs = export.io_specs(exported)
    loaded = torch.export.load(path).module()
    h, w = FULL_HW
    canvas = np.random.RandomState(0).randn(h, w, 3).astype(np.float32)
    image = torch.from_numpy(canvas).permute(2, 0, 1)[None].contiguous() \
        .cuda()
    img_hw = torch.tensor([[float(h), float(w)]], device='cuda')
    timed = 10
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        ms = {}
        for name, fn in (('eager', lambda: model.forward_test(
                dict(image=image, img_hw=img_hw))),
                         ('exported', lambda: loaded(image, img_hw))):
            for _ in range(2):
                out = fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(timed):
                out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t) * 1e3 / timed
            if name == 'eager':
                eager = out
            else:
                exported_diff = scaled_diff(np, out[0].cpu().numpy(),
                                            eager[0].cpu().numpy())
                check(exported_diff <= 1e-4 and
                      all(torch.equal(a, b) for a, b in zip(out[1:],
                                                            eager[1:])),
                      f'export: the exported program differs from eager by '
                      f'{exported_diff}')
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        check(launches == 2 * (2 + timed),
              f'export: {launches} nms_keep launches for {2 * (2 + timed)} '
              'calls')
        outs = model(image)
        captured = []

        def capture(boxes, valid, thr):
            captured.append((boxes, valid, thr))
            return nms_keep(boxes, valid, thr)
        model.bbox_head.get_bboxes(outs, img_hw, keep_fn=capture)
        check(torch.equal(nms_keep(*captured[0]),
                          nms_keep_ref(*captured[0])),
              'export: the kernel keep mask differs from the plain one')
    script = os.path.join(ROOT, 'ld_tpu_torch', 'tools', 'deployment',
                          'run_export.py')
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-c', RUN_EXPORT_CHILD.format(path=script), path,
         '--score-thr', '0'], capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'run_export.py failed:\n{proc.stderr}')
    body, info = proc.stdout.rsplit('\n', 2)[:2]
    info = json.loads(info)
    got = json.loads(body)['detections']
    dets, labels, valid = (t[0].cpu().numpy() for t in eager)
    keep = valid & (dets[:, 4] > 0)
    want = [dict(bbox=d[:4].tolist(), score=float(d[4]), label=int(lab))
            for d, lab in zip(dets[keep], labels[keep])]
    check(len(got) > 0 and same_detections(np, got, want),
          f'run_export.py: {len(got)} detections differ from eager '
          f'forward_test\'s {len(want)}')
    check(info['launches'] == 1 and
          info['modules'] == ['ld_tpu_torch.ops.nms_cuda'],
          f'run_export.py: {info}')
    emit(dict(phase='export', nvidia_smi=smi, config=CONFIG,
              tool='ld_tpu_torch/tools/deployment/export.py',
              input=[1, 3, h, w], export_s=export_s,
              pt2_bytes=os.path.getsize(path), inputs=inputs,
              outputs=outputs, forward_test_ms_eager=ms['eager'],
              forward_test_ms_exported=ms['exported'],
              exported_max_abs_diff_vs_eager=exported_diff,
              run_export_s=child_s,
              run_export_detections=len(got),
              run_export_launches=info['launches'],
              run_export_modules=info['modules'],
              nms_keep_launches=launches + info['launches']))
    return launches + info['launches']


def phase_deploy(torch, np, smi):
    """The serve_http and export phases over one work dir (removed at the
    end); returns their launches."""
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_deploy')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    serve_launches, ckpt = phase_serve_http(torch, np, smi, work)
    emit(dict(phase='serve_http_done', seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    export_launches = phase_export(torch, np, smi, work, ckpt)
    emit(dict(phase='export_done', seconds=time.perf_counter() - t0))
    shutil.rmtree(work, ignore_errors=True)
    return serve_launches, export_launches


def flat_tensors(obj):
    """Every tensor of a nest of lists and tuples, in order."""
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in flat_tensors(x)]
    return [obj]


def build_plain(torch, config, seed=0, edit=None, depth=None):
    """A config's detector on the CPU in float32, from `seed`, after
    `edit(cfg)` where given, its backbone at `depth` where given; returns
    (cfg, model)."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    cfg = Config.fromfile(os.path.join(ROOT, config))
    if edit is not None:
        edit(cfg)
    if depth is not None:
        cfg.model.backbone.depth = depth
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(seed))
    return cfg, model


def depth_config(config, depth=DEPTH_CUT):
    """`config` with its backbone at `depth`, and the backbone of the
    teacher it names by path at `depth` too, written under
    work_dirs/chip_smoke_depth/ (widths, heads and schedules kept);
    returns the written file's path."""
    from ld_tpu_torch import Config
    out = os.path.join(ROOT, 'work_dirs', 'chip_smoke_depth')
    os.makedirs(out, exist_ok=True)
    cfg = Config.fromfile(os.path.join(ROOT, config))
    cfg.model.backbone.depth = depth
    teacher = cfg.model.get('teacher_config')
    if isinstance(teacher, str):
        cfg.model.teacher_config = depth_config(teacher, depth)
    path = os.path.join(out, '{}_d{}.py'.format(
        os.path.splitext(os.path.basename(config))[0], depth))
    cfg.dump(path)
    return path


def detector_steps(torch, smi, cfg, base, warmup, timed, per_step, phase,
                   batch_size=2, pad=(800, 1344), profile=False, batch=None,
                   range_of=None, prof_steps=1, inspect=None):
    """`warmup` + `timed` training steps of a copy of `base` on the card
    (the config's SGD and schedule, `batch` on the card or a seeded batch
    of `batch_size` at `pad`): every loss finite and `per_step` nms_keep
    launches a step; with `profile`, the device's time by kernel over
    `prof_steps` more steps, and with `range_of` (a module class) the share
    of it that
    the forwards of those modules launch; `inspect(model)` adds figures of
    the stepped model to the row. Returns the launch count of the steps
    and the emitted row."""
    import copy
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.testing import detection_batch
    model = copy.deepcopy(base).to('cuda')
    step, optimizer = make_step(cfg, model)
    if batch is None:
        batch = detection_batch(batch_size, *pad, num_classes=80, seed=0,
                                device='cuda')
    batch_size, pad = batch['image'].shape[0], batch['image'].shape[-2:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    config = os.path.relpath(cfg.filename, ROOT)

    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    step_ms, history = [], []
    for i in range(warmup + timed):
        before = nms_keep.launches
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
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               detector=type(model).__name__,
               batch=[batch_size, 3, *map(int, pad)],
               params=sum(p.numel() for p in model.parameters()),
               warmup_steps=warmup, timed_steps=timed, step_ms=step_ms,
               step_ms_mean=sum(step_ms) / len(step_ms),
               img_per_s=batch_size * 1e3 * len(step_ms) / sum(step_ms),
               loss_first=history[0], loss_last=history[-1],
               nms_keep_launches=launches,
               nms_keep_launches_per_step=per_step,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if hasattr(model, 'teacher'):
        row['params_teacher'] = sum(p.numel()
                                    for p in model.teacher.parameters())
    if inspect is not None:
        row.update(inspect(model))
    if profile and range_of is None:
        row.update(step_profile(torch, step, batch, prof_steps, top_n=12))
    elif profile:
        with module_ranges(model, range_of, 'module_range') as n:
            row.update(step_profile(torch, step, batch, prof_steps, top_n=12,
                                    ranges='module_range'),
                       module_range_of=range_of.__name__,
                       module_range_modules=n)
    emit(row)
    del model, step, optimizer, batch
    torch.cuda.empty_cache()
    return launches, row


def outputs_reference(torch, np, base, scaled=False, hw=(128, 192)):
    """`base`'s outputs (a dense head's, or a two-stage detector's FPN and
    RPN outputs) at 1x3x128x192 on the card against the CPU, within the
    bounds of phase_reference; returns (max abs, max median relative).
    With `scaled`, for outputs far from unit scale (an HRNet's FPN levels
    reach ~3e3 at random weights, an R50's ~10), the max-abs bound is
    5e-5 of each output's largest |value| in place of 5e-3 absolute, and
    the largest such ratio is returned as the first figure."""
    import copy
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, *hw)
                         .astype(np.float32))
    cpu = copy.deepcopy(base).eval()
    card = copy.deepcopy(base).to('cuda').eval()
    with torch.inference_mode():
        c_outs, g_outs = flat_tensors(cpu(x)), flat_tensors(card(x.cuda()))
        worst, worst_med = head_output_diff([c_outs], [g_outs])
        ratio = max(float((g.cpu() - c).abs().max() / c.abs().max())
                    for c, g in zip(c_outs, g_outs))
    if scaled:
        check(ratio < 5e-5 and worst_med < 2e-4,
              f'card vs CPU outputs: max {worst} ({ratio} of the largest '
              f'value), median rel {worst_med}')
        worst = ratio
    else:
        check(worst < 5e-3 and worst_med < 2e-4,
              f'card vs CPU outputs: max {worst}, median rel {worst_med}')
    del card
    torch.cuda.empty_cache()
    return worst, worst_med


def phase_classic_heads(torch, np, smi):
    """RetinaNet, FCOS and ATSS at full width: `forward_test` at 800x1344,
    training steps at batch 2, and the card against the CPU at a small
    size; returns the kernel's launch count over their main paths."""
    t0 = time.perf_counter()
    launches = 0
    for config in CLASSIC_CONFIGS:
        n, _ = family_serve(torch, smi, config, warmup=1, timed=5,
                            phase='classic_heads_serve')
        launches += n
        cfg, base = build_plain(torch, config)
        n, _ = detector_steps(torch, smi, cfg, base, *CLASSIC_STEPS,
                              per_step=0, phase='classic_heads_train')
        launches += n
        worst, worst_med = outputs_reference(torch, np, base)
        emit(dict(phase='classic_heads_outputs_reference', config=config,
                  input='1x3x128x192', max_abs_diff=worst,
                  max_median_rel_diff=worst_med, tol_abs=5e-3,
                  tol_median_rel=2e-4))
        phase_train_reference(torch, cfg, base, gi=False,
                              phase='classic_heads_reference')
    emit(dict(phase='classic_heads_done', seconds=time.perf_counter() - t0,
              budget_s=45, nms_keep_launches=launches))
    return launches


def sample_everything(model):
    """`model`'s RPN and RoI samplers set to pick every candidate, so that
    the losses do not depend on the generator's stream."""
    from ld_tpu_torch.ops.samplers import RandomSampler
    model.rpn_head.num_samples, model.rpn_head.pos_fraction = 10**9, 1.0
    model.roi_head.num_samples = 10**9
    model.roi_head.sampler = RandomSampler(num=10**9, pos_fraction=1.0)
    return model


def sampler_of_type(model, candidates):
    """`model`'s RoI sampler rebuilt as its config's type (its sub-samplers
    too) at num = `candidates`, the candidates an image, and pos_fraction
    1: every candidate is picked, and ScoreHLR's label weights still decay
    from 1 over the importance ranks."""
    from ld_tpu_torch.ops.samplers import build_sampler
    roi = model.roi_head
    cfg = dict(roi.train_cfg.get('sampler') or {})
    roi.num_samples = candidates
    roi.sampler = build_sampler(dict(
        cfg, type=cfg.get('type', 'RandomSampler'), num=candidates,
        pos_fraction=1.0))
    return model


def two_stage_reference(torch, np, base):
    """The card against the CPU at 1x3x128x192 on `base`'s weights with
    samplers that pick every candidate: the FPN and RPN outputs, the RPN
    losses, and the RoI losses on the CPU's proposals, rtol 1e-3 a term."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    worst, worst_med = outputs_reference(torch, np, base)
    runs, props = {}, None
    for device in ('cpu', 'cuda'):
        model = sample_everything(copy.deepcopy(base)).to(device).train()
        batch = detection_batch(1, 128, 192, seed=0, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        feats, rpn_outs = model(batch['image'])
        sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
        losses = model.rpn_head.loss(rpn_outs, batch, sizes, gen)
        if props is None:
            props = model._proposals(rpn_outs, batch['img_hw'])
        losses.update(model.roi_head.forward_train(
            feats, *(p.to(device) for p in props), batch, gen))
        runs[device] = {k: float(v.detach()) for k, v in losses.items()}
        del model, feats, rpn_outs
    c_loss, g_loss = runs['cpu'], runs['cuda']
    rel = {k: abs(g_loss[k] - c) / abs(c) for k, c in c_loss.items() if c}
    emit(dict(phase='two_stage_reference', config=FASTER_CONFIG,
              input='1x3x128x192', max_abs_diff=worst,
              max_median_rel_diff=worst_med, tol_abs=5e-3,
              tol_median_rel=2e-4, proposals=int(props[1].sum()),
              loss_cpu=c_loss, loss_card=g_loss, rel_diff=rel, rtol=1e-3))
    for k, c in c_loss.items():
        check(abs(g_loss[k] - c) <= 1e-3 * abs(c),
              f'{k}: card {g_loss[k]!r} vs CPU {c!r} beyond rtol 1e-3')
    torch.cuda.empty_cache()


def phase_two_stage(torch, np, smi):
    """Faster R-CNN R50 at full width through `inference_detector`,
    `forward_test` at batch 1 and 2 and training steps, the card against
    the CPU, the KD two-stage detector's steps, and the kernel alone at the
    RPN's K; returns the launch count over the main paths and the K = 4819
    rows by B."""
    from ld_tpu_torch.apis import inference_detector, init_detector
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    t_phase = time.perf_counter()
    model = init_detector(float32_cfg(FASTER_CONFIG), device='cuda', seed=0)
    # fc_cls at std 1 (its init's x 100): a softmax over the 81 classes
    # peaked enough that the RoI head's NMS sees candidates above score_thr
    with torch.no_grad():
        model.roi_head.bbox_head.fc_cls.weight.mul_(100.0)
    rng = np.random.RandomState(0)
    sizes = [(480, 640), (800, 1333), (640, 480), (427, 640)]
    images = [rng.randint(0, 256, hw + (3, ), np.uint8) for hw in sizes]
    gen = torch.Generator('cuda').manual_seed(0)
    benches = {b: dict(image=torch.randn(b, 3, 800, 1344, device='cuda',
                                         generator=gen),
                       img_hw=torch.tensor([[800.0, 1344.0]] * b,
                                           device='cuda'))
               for b in (1, 2)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    calls = 0
    latencies = []
    for img in images:
        t = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t) * 1e3)
        calls += 1
        check(res['boxes'].shape[1] == 5 and
              np.isfinite(res['boxes']).all(), 'inference_detector boxes')
    fwd_ms = {}
    with torch.inference_mode():
        for b, bench in benches.items():
            for _ in range(2):
                model.forward_test(bench)
                calls += 1
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t = time.perf_counter()
                dets, _, valid = model.forward_test(bench)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                calls += 1
            fwd_ms[b] = times
            check(tuple(dets.shape) == (b, 100, 5) and
                  bool(torch.isfinite(dets).all()) and
                  bool(valid.any(dim=1).all()), f'forward_test at batch {b}')
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    serve_peak = torch.cuda.max_memory_allocated()
    check(launches == 2 * calls, f'nms_keep launched {launches} times for '
          f'{calls} forward_test calls (2 a call)')

    # both NMS of one batch-2 call again, with the plain keep mask
    bench = benches[2]
    captured = []

    def capture(boxes, valid, thr):
        captured.append((boxes.clone(), valid.clone(), thr))
        return nms_keep(boxes, valid, thr)
    with torch.inference_mode():
        feats, rpn_outs = model(bench['image'])
        props = model.rpn_head.get_proposals(rpn_outs, bench['img_hw'],
                                             keep_fn=capture)
        plain = model.rpn_head.get_proposals(rpn_outs, bench['img_hw'],
                                             keep_fn=nms_keep_ref)
        check(all(torch.equal(a, b) for a, b in zip(props, plain)),
              'RPN proposals with the kernel differ from the plain keep mask')
        got = model.roi_head.simple_test(feats, *props, bench['img_hw'],
                                         keep_fn=capture)
        want = model.roi_head.simple_test(feats, *props, bench['img_hw'],
                                          keep_fn=nms_keep_ref)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              'detections with the kernel differ from the plain keep mask')
    rpn_boxes, rpn_valid, rpn_thr = captured[0]
    check(tuple(rpn_boxes.shape) == (2, RPN_K, 4) and
          captured[1][0].shape[1] == 1024,
          f'NMS at K = {rpn_boxes.shape[1]} (RPN), '
          f'{captured[1][0].shape[1]} (RoI head)')
    emit(dict(phase='two_stage_serve', config=FASTER_CONFIG, nvidia_smi=smi,
              params=sum(p.numel() for p in model.parameters()),
              request_sizes=sizes, latency_ms=latencies,
              forward_test_ms_b1=fwd_ms[1],
              forward_test_ms_b1_mean=sum(fwd_ms[1]) / len(fwd_ms[1]),
              forward_test_ms_b2=fwd_ms[2],
              forward_test_ms_b2_mean=sum(fwd_ms[2]) / len(fwd_ms[2]),
              max_memory_allocated_bytes=serve_peak,
              nms_keep_launches=launches, nms_keep_launches_per_call=2,
              rpn_nms_k=RPN_K, roi_nms_k=1024,
              proposals=props[1].sum(dim=1).tolist(),
              detections=int(got[2].sum()), plain_keep_identical=True))
    del model, feats, rpn_outs, props, plain, got, want, benches, bench
    torch.cuda.empty_cache()

    # the kernel alone on the RPN's own candidates: no main path's launch
    rows = kernel_rows(torch, smi, [
        (rpn_boxes[:b].contiguous(), rpn_valid[:b].contiguous(), rpn_thr)
        for b in (1, 2)], ('rpn_proposals', 'rpn_proposals'))
    k4819 = {row['B']: row for row in rows}

    cfg, base = build_plain(torch, FASTER_CONFIG)
    n, _ = detector_steps(torch, smi, cfg, base, 2, 5, per_step=1,
                          phase='two_stage_train', profile=True)
    launches += n
    two_stage_reference(torch, np, base)
    del base

    cfg.model.type = 'KnowledgeDistillationTwoStageDetector'
    cfg.model.teacher_config = KD_TEACHER_CONFIG
    kd = build_detector(cfg.model)
    kd.init_weights(torch.Generator().manual_seed(0))
    kd.init_teacher_weights(torch.Generator().manual_seed(1))
    check(kd.fold_teacher_bn(), 'the teacher BN fold was refused')
    n, row = detector_steps(torch, smi, cfg, kd, 1, 2, per_step=1,
                            phase='two_stage_kd')
    launches += n
    check({'loss_rpn_kd', 'loss_rpn_ld'} <= set(row['loss_last']),
          'the KD two-stage step has no loss_rpn_kd / loss_rpn_ld')
    del kd
    torch.cuda.empty_cache()
    emit(dict(phase='two_stage_done', seconds=time.perf_counter() - t_phase,
              budget_s=90, nms_keep_launches=launches))
    return launches, k4819


def mask_batch(torch, dataset, data_cfg):
    """The first batch of `dataset` (2 images) through the data layer to
    the card: the config's pad buckets and gt slots, gt_masks as uint8."""
    from ld_tpu_torch.data import DevicePrefetcher, build_dataloader
    loader = build_dataloader(dataset, 2, 1, data_cfg.pad_to,
                              data_cfg.max_gts_per_image, shuffle=False)
    check(loader.with_masks, 'the loader carries no gt_masks')
    batch = next(iter(DevicePrefetcher(loader, 'cuda')))
    check(batch['gt_masks'].dtype == torch.uint8 and
          tuple(batch['gt_masks'].shape[2:]) == tuple(
              s // 4 for s in batch['image'].shape[-2:]) and
          int(batch['gt_masks'].sum()) > 0, 'gt_masks of the batch')
    return batch


def instance_train_batch(torch, data_cfg):
    """Two synthetic 800x1333 images of 80 classes with box-region masks
    through coco_instance.py's train pipeline after its file loaders, to
    the card."""
    from ld_tpu_torch.data import build_dataset
    pipe = [t for t in data_cfg.train_pipeline
            if t['type'] not in ('LoadImageFromFile', 'LoadAnnotations')]
    train_set = build_dataset(dict(
        type='SyntheticDetectionDataset', num_images=2, hw=(800, 1333),
        num_classes=80, max_boxes=6, pipeline=pipe, seed=0))
    return mask_batch(torch, train_set, data_cfg)


def all_rois_mask_loss(roi_head, feats, s, gt_masks):
    """`StandardRoIHead.mask_loss` with the tower on every sampled roi, as
    the JAX head runs it: the design the positive slice is measured
    against. Bound to a RoI head as a method, so that a deep copy of the
    model rebinds it to the copy's head."""
    return roi_head.mask_head.loss(
        roi_head._mask_feats(feats, s['rois'], s['roi_pos']), s['rois'],
        s['roi_pos'], s['labels'], s['gt_inds'], gt_masks)


def peak_scores(torch, model):
    """`model` with its RoI head's fc_cls (each cascade stage's) at std 1,
    its init's x 100: a softmax over the 81 classes peaked enough that the
    RoI head's NMS sees candidates above score_thr."""
    heads = model.roi_head.bbox_head
    with torch.no_grad():
        for head in heads if isinstance(heads, torch.nn.ModuleList) \
                else [heads]:
            head.fc_cls.weight.mul_(100.0)
    return model


def box_masks(torch, np, batch, seed=2):
    """(B, 100, H/4, W/4) uint8 gt masks of `batch`: random pixels of each
    valid gt's box."""
    rs = np.random.RandomState(seed)
    b, g = batch['gt_bboxes'].shape[:2]
    h, w = (s // 4 for s in batch['image'].shape[-2:])
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        for j in np.flatnonzero(batch['gt_valid'][i].numpy()):
            x1, y1, x2, y2 = (batch['gt_bboxes'][i, j].numpy() / 4).astype(
                int)
            masks[i, j, y1:y2 + 1, x1:x2 + 1] = rs.rand(
                y2 + 1 - y1, x2 + 1 - x1) > 0.3
    return torch.from_numpy(masks)


def roi_serve(torch, smi, model, config, phase, batches=(1, 2), warmup=2,
              timed=5, prof_iters=1, max_dets=100, mask_size=28):
    """`forward_test` of a two-stage `model` on the card at 800x1344:
    `warmup` + `timed` calls at each batch size, 2 launches a call (the
    RPN's NMS of the batch and the RoI head's), the outputs checked (with
    test masks the 4th, (B, 100, 28, 28) in [0, 1]); at the largest batch
    both NMS again with the plain keep mask, identical outputs; the device's
    busy share at the smallest over `prof_iters` profiled calls. Emits the
    row; returns (launches, row, the captured NMS inputs (boxes, valid,
    thr) of the largest batch's call). `max_dets`: the test config's
    max_per_img; `mask_size`: the test masks' side (28, the C4 head's
    14)."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    gen = torch.Generator('cuda').manual_seed(0)
    benches = {b: dict(image=torch.randn(b, 3, 800, 1344, device='cuda',
                                         generator=gen),
                       img_hw=torch.tensor([[800.0, 1344.0]] * b,
                                           device='cuda'))
               for b in batches}
    with_masks = model.roi_head.with_test_masks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path (serving): counts from 0, read right after --------
    nms_keep.launches = 0
    calls = 0
    fwd_ms = {}
    with torch.inference_mode():
        for b, bench in benches.items():
            for _ in range(warmup):
                model.forward_test(bench)
                calls += 1
            torch.cuda.synchronize()
            times = []
            for _ in range(timed):
                t = time.perf_counter()
                outs = model.forward_test(bench)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                calls += 1
            fwd_ms[b] = times
            dets, _, valid = outs[:3]
            check(len(outs) == 3 + with_masks and
                  tuple(dets.shape) == (b, max_dets, 5) and
                  bool(torch.isfinite(dets).all()) and
                  bool(valid.any(dim=1).all()),
                  f'{config} forward_test at batch {b}')
            if with_masks:
                masks = outs[3]
                check(tuple(masks.shape) == (b, max_dets, mask_size,
                                             mask_size) and
                      bool(torch.isfinite(masks).all()) and
                      0 <= float(masks.min()) and float(masks.max()) <= 1,
                      f'{config} forward_test masks at batch {b}')
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    check(launches == 2 * calls, f'{config}: nms_keep launched {launches} '
          f'times for {calls} forward_test calls (2 a call)')
    bench = benches[max(batches)]
    captured = []

    def capture(boxes, valid, thr):
        captured.append((boxes.clone(), valid.clone(), thr))
        return nms_keep(boxes, valid, thr)
    with torch.inference_mode():
        feats, rpn_outs = model(bench['image'])
        if hasattr(model, 'test_branch'):     # a TridentNet's test branch
            feats, rpn_outs = model.test_branch(feats, rpn_outs,
                                                bench['image'].shape[0])
        outs = {}
        for name, keep in (('kernel', capture), ('plain', nms_keep_ref)):
            props = model.rpn_head.get_proposals(rpn_outs, bench['img_hw'],
                                                 keep_fn=keep)
            outs[name] = model.roi_head.simple_test(
                feats, *props, bench['img_hw'], keep_fn=keep)
        check(all(torch.equal(a, b) for a, b in zip(outs['kernel'],
                                                    outs['plain'])),
              f'{config}: outputs with the kernel differ from the plain '
              'keep mask')
    prof = phase_profile(torch, model, benches[min(batches)],
                         iters=prof_iters, phase=f'{phase}_profile')
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               detector=type(model).__name__,
               params=sum(p.numel() for p in model.parameters()),
               max_memory_allocated_bytes=peak,
               nms_keep_launches=launches, nms_keep_launches_per_call=2,
               nms_k=[c[0].shape[1] for c in captured],
               detections=int(outs['kernel'][2].sum()),
               plain_keep_identical=True,
               device_busy_share=prof.get('device_busy_share'),
               device_ms_b1=prof.get('device_ms_per_iter'))
    for b, times in fwd_ms.items():
        row[f'forward_test_ms_b{b}'] = times
        row[f'forward_test_ms_b{b}_mean'] = sum(times) / len(times)
    emit(row)
    del feats, rpn_outs, outs, benches, bench
    torch.cuda.empty_cache()
    return launches, row, captured


def roi_reference(torch, np, base, config, phase, proposals=50,
                  scaled=False, own_sampler=False):
    """The card against the CPU at 1x3x128x192 on `base`'s weights with
    samplers that pick every candidate and box-region gt masks: the FPN and
    RPN outputs (5e-3 / 2e-4; with `scaled`, 5e-5 of each output's largest
    value, `outputs_reference`), every loss (the RPN's and the RoI head's,
    the mask and semantic losses included) on the CPU's top `proposals`
    proposals (None: all; 50 by default: the mask towers run on every
    sampled roi there, the references' largest CPU cost), rtol 1e-3 a
    term; with test masks, the masks of
    the CPU's detections (of a copy with peaked scores, tested on its top
    `proposals` proposals) within 5e-3. A TridentNet's losses are those of
    its branch-tiled gts (`tile_batch`). With
    `own_sampler` the RoI head keeps its config's sampler type
    (`sampler_of_type`)."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    worst, worst_med = outputs_reference(torch, np, base, scaled)
    cpu_batch = detection_batch(1, 128, 192, seed=0, device='cpu')
    cpu_batch['gt_masks'] = box_masks(torch, np, cpu_batch)
    dets = None
    if base.roi_head.with_test_masks:
        peaked = peak_scores(torch, copy.deepcopy(base).eval())
        if proposals is not None:
            # the CPU's test on its top `proposals` proposals too (a C4
            # head runs res5 on every one)
            peaked.rpn_head.test_cfg = dict(peaked.rpn_head.test_cfg,
                                            max_per_img=proposals)
        with torch.inference_mode():
            dets = peaked.forward_test(cpu_batch)[:3]
        del peaked
    runs, masks, props = {}, {}, None
    for device in ('cpu', 'cuda'):
        model = sample_everything(copy.deepcopy(base)).to(device).train()
        batch = {k: v.to(device) for k, v in cpu_batch.items()}
        gen = torch.Generator(device=device).manual_seed(0)
        feats, rpn_outs = model(batch['image'])
        if hasattr(model, 'tile_batch'):      # a TridentNet's branches
            batch = model.tile_batch(batch)
        sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
        losses = model.rpn_head.loss(rpn_outs, batch, sizes, gen)
        if props is None:
            props = [p[:, :proposals] for p in model._proposals(
                rpn_outs, batch['img_hw'])]
        if own_sampler:
            sampler_of_type(model, batch['gt_bboxes'].shape[1] +
                            props[0].shape[1])
        losses.update(model.roi_head.forward_train(
            feats, *(p.to(device) for p in props), batch, gen))
        runs[device] = {k: float(v.detach()) for k, v in losses.items()}
        if dets is not None:
            with torch.inference_mode():
                masks[device] = model.eval().roi_head.simple_test_mask(
                    [f.detach() for f in feats],
                    *(d.to(device) for d in dets)).cpu()
        del model, feats, rpn_outs
    c_loss, g_loss = runs['cpu'], runs['cuda']
    rel = {k: abs(g_loss[k] - c) / abs(c) for k, c in c_loss.items() if c}
    row = dict(phase=phase, config=config, input='1x3x128x192',
               **({'max_diff_of_largest': worst, 'tol_of_largest': 5e-5}
                  if scaled else {'max_abs_diff': worst, 'tol_abs': 5e-3}),
               max_median_rel_diff=worst_med, tol_median_rel=2e-4,
               proposals=int(props[1].sum()), loss_cpu=c_loss,
               loss_card=g_loss, rel_diff=rel, rtol=1e-3)
    if dets is not None:
        row.update(detections=int(dets[2].sum()), mask_tol=5e-3,
                   mask_max_abs_diff=float(
                       (masks['cuda'] - masks['cpu']).abs().max()))
        check(row['detections'] > 0, f'{config}: no reference detection')
        check(row['mask_max_abs_diff'] <= 5e-3,
              f"{config} masks: card vs CPU {row['mask_max_abs_diff']}")
    emit(row)
    for k, c in c_loss.items():
        check(abs(g_loss[k] - c) <= 1e-3 * abs(c),
              f'{config} {k}: card {g_loss[k]!r} vs CPU {c!r} beyond rtol '
              '1e-3')
    torch.cuda.empty_cache()
    return row


def segm_eval(torch, np, smi, model, work, config, phase, data_cfg):
    """`eval_detector` -> `evaluate(['bbox', 'segm'])` of a mask `model`
    over a polygon set with crowds (`MASK_EVAL_SET`, batch 2; 2 launches a
    batch), and the set's gts as detections scoring segm and bbox AP 1.0;
    returns the launch count."""
    from ld_tpu_torch.apis import eval_detector
    from ld_tpu_torch.data import build_dataset
    from ld_tpu_torch.evaluation.coco_mask import poly_to_mask
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.testing import write_coco_instances
    count, sizes = MASK_EVAL_SET
    ann, prefix = write_coco_instances(os.path.join(work, 'eval'), count,
                                       sizes=sizes, seed=2)
    val = build_dataset(dict(type='CocoDataset', ann_file=ann,
                             img_prefix=prefix, test_mode=True,
                             pipeline=data_cfg.test_pipeline))
    # ---- the main path (evaluation): counts from 0, read right after -----
    nms_keep.launches = 0
    t = time.perf_counter()
    results = eval_detector(model, val, samples_per_gpu=2,
                            pad_hw=data_cfg.pad_to)
    eval_s = time.perf_counter() - t
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    batches = sum(-(-int(n) // 2) for n in np.bincount(val.flag))
    check(launches == 2 * batches,
          f'eval: {launches} launches for {batches} batches (2 each)')
    check(all(r['masks'].shape == (len(r['boxes']), 28, 28)
              for r in results), 'eval results without their masks')
    t = time.perf_counter()
    metrics = val.evaluate(results, metric=['bbox', 'segm'])
    metric_s = time.perf_counter() - t
    check(len(metrics) == 24 and all(
        not math.isfinite(v) or 0 <= v <= 1 for v in metrics.values()),
        f'evaluate: {metrics}')
    gts = []
    for i, info in enumerate(val.img_infos):
        a = val.get_ann_info(i)
        gts.append(dict(
            boxes=np.concatenate([a['bboxes'], np.ones((len(a['bboxes']),
                                                        1))], 1),
            labels=a['labels'],
            masks=[poly_to_mask(p, info['height'], info['width'])
                   .astype(np.float32) for p in a['masks']]))
    gt_metrics = val.evaluate(gts, metric=['bbox', 'segm'])
    check(gt_metrics['segm_mAP'] == 1.0 and gt_metrics['bbox_mAP'] == 1.0,
          f'the gts as detections score {gt_metrics}')
    emit(dict(phase=phase, config=config, nvidia_smi=smi, images=count,
              sizes=sizes, eval_detector_s=eval_s,
              eval_img_per_s=count / eval_s, evaluate_s=metric_s,
              metrics=metrics, gt_segm_mAP=gt_metrics['segm_mAP'],
              gt_bbox_mAP=gt_metrics['bbox_mAP'],
              nms_keep_launches=launches))
    return launches


def phase_mask_rcnn(torch, np, smi):
    """Mask R-CNN R50 at full width: `forward_test` at batch 1 and 2 with
    its masks, training steps with gt_masks through coco_instance.py's
    pipeline (the mask tower on the positive slice, and once on every
    roi), the card against the CPU, the X101-32x8d config's steps through
    its own mask-loading pipeline, and `eval_detector` ->
    `evaluate(['bbox', 'segm'])` over a polygon set; returns the kernel's
    launch count over the main paths."""
    import copy
    import types
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.data import build_dataset
    from ld_tpu_torch.testing import write_coco_instances
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_mask_rcnn')
    shutil.rmtree(work, ignore_errors=True)
    data_cfg = Config.fromfile(os.path.join(ROOT, MASK_DATA_CONFIG))
    model = peak_scores(torch, init_detector(float32_cfg(MASK_CONFIG),
                                             device='cuda', seed=0))
    serve_launches, _, _ = roi_serve(torch, smi, model, MASK_CONFIG,
                                     'mask_rcnn_serve')

    # training: coco_instance.py's train pipeline over synthetic images
    batch = instance_train_batch(torch, data_cfg)
    cfg, base = build_plain(torch, MASK_CONFIG)
    train_launches, row = detector_steps(
        torch, smi, cfg, base, 2, 5, per_step=1, phase='mask_rcnn_train',
        profile=True, batch=batch)
    check(row['loss_last'].get('loss_mask', 0) > 0, 'no loss_mask')
    check(base.roi_head.sampler.max_pos == 128,
          'the mask tower does not run on a 128-roi slice')
    all_rois = copy.deepcopy(base)
    all_rois.roi_head.mask_loss = types.MethodType(all_rois_mask_loss,
                                                   all_rois.roi_head)
    n, all_row = detector_steps(torch, smi, cfg, all_rois, 1, 2,
                                per_step=1, phase='mask_rcnn_train_all_rois',
                                batch=batch)
    train_launches += n
    first, all_first = row['loss_first'], all_row['loss_first']
    check(abs(all_first['loss_mask'] - first['loss_mask']) <=
          1e-4 * abs(first['loss_mask']),
          f"loss_mask on the positive slice {first['loss_mask']!r}, on "
          f"every roi {all_first['loss_mask']!r}")
    del all_rois, batch
    roi_reference(torch, np, base, MASK_CONFIG, 'mask_rcnn_reference')
    del base

    # the X101-32x8d config through its own pipeline over a polygon set
    x_cfg = float32_cfg(MASK_X101_CONFIG)
    ann, prefix = write_coco_instances(os.path.join(work, 'train'), 2,
                                       sizes=((800, 1333), ), seed=1)
    x_set = build_dataset(dict(x_cfg.data['train'], ann_file=ann,
                               img_prefix=prefix))
    batch = mask_batch(torch, x_set, data_cfg)
    _, x_base = build_plain(torch, MASK_X101_CONFIG)
    n, x_row = detector_steps(torch, smi, x_cfg, x_base, 1, 2, per_step=1,
                              phase='mask_rcnn_x101_train', batch=batch)
    train_launches += n
    check(x_row['loss_last'].get('loss_mask', 0) > 0, 'no X101 loss_mask')
    del x_base, batch, x_set
    torch.cuda.empty_cache()

    eval_launches = segm_eval(torch, np, smi, model, work, MASK_CONFIG,
                              'mask_rcnn_eval', data_cfg)
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    launches = serve_launches + train_launches + eval_launches
    emit(dict(phase='mask_rcnn_done', seconds=time.perf_counter() - t_phase,
              budget_s=90, nms_keep_launches=launches))
    return launches


def kernel_rows(torch, smi, captured, names):
    """The kernel alone on NMS inputs captured from a main path's call (no
    main path's launch): bit-identical with nms_keep_ref; event, host and
    device ms, the plain version's ms and the bound, one row each."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    rows = []
    for (boxes, valid, thr), name in zip(captured, names):
        b, k = boxes.shape[:2]
        got = nms_keep(boxes, valid, thr)
        check(torch.equal(got, nms_keep_ref(boxes, valid, thr)),
              f'kernel keep mask differs from plain at {name}, K = {k}')
        ms, host_ms = cuda_ms(lambda: nms_keep(boxes, valid, thr), iters=100)
        dev = kernel_device_ms(torch, lambda: nms_keep(boxes, valid, thr),
                               NMS_KERNELS)
        plain_ms, _ = cuda_ms(lambda: nms_keep_ref(boxes, valid, thr),
                              iters=10)
        bound, bound_by = nms_bound_ms(b, k)
        row = dict(phase='kernel_time', set=name, K=k, B=b,
                   kept=int(got.sum()), valid=int(valid.sum()), ms=ms,
                   host_ms=host_ms, device_ms=dev and sum(dev.values()),
                   **{f'device_ms_{n}': dev and dev[n] for n in NMS_KERNELS},
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   bit_identical=True, nvidia_smi=smi)
        emit(row)
        rows.append(row)
    return rows


def phase_cascade(torch, np, smi):
    """Cascade R-CNN, Cascade Mask R-CNN and HTC R50 at full width:
    `forward_test` at 800x1344 (batch 1 and 2; HTC batch 1), training
    steps at batch 2 with gt_masks through coco_instance.py's train
    pipeline, the card against the CPU, Cascade Mask R-CNN's evaluation
    over a polygon set, and the kernel alone on the cascade's own NMS
    inputs; returns the kernel's launch count over the main paths and the
    kernel rows."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import init_detector
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_cascade')
    shutil.rmtree(work, ignore_errors=True)
    data_cfg = Config.fromfile(os.path.join(ROOT, MASK_DATA_CONFIG))
    batch = instance_train_batch(torch, data_cfg)
    launches, kernels = 0, None
    for config, batches, steps, reference in CASCADE_CONFIGS:
        model = peak_scores(torch, init_detector(float32_cfg(config),
                                                 device='cuda', seed=0))
        n, _, captured = roi_serve(torch, smi, model, config,
                                   'cascade_serve', batches=batches)
        launches += n
        if kernels is None:
            kernels = kernel_rows(torch, smi, captured,
                                  ('cascade_rpn', 'cascade_roi'))
        cfg, base = build_plain(torch, config)
        n, row = detector_steps(torch, smi, cfg, base, *steps, per_step=1,
                                phase='cascade_train', profile=True,
                                batch=batch)
        launches += n
        losses = row['loss_last']
        check(all(f'loss_{k}_s{i}' in losses for i in range(3)
                  for k in ('cls', 'bbox')), f'{config}: stage losses')
        check(('loss_mask_s2' in losses) ==
              (base.roi_head.mask_head is not None), f'{config}: loss_mask_s2')
        check(('loss_semantic_seg' in losses) == ('htc' in config),
              f'{config}: loss_semantic_seg')
        if reference:
            # the mask towers run on every sampled roi of three stages:
            # the CPU's top 20 proposals
            roi_reference(torch, np, base, config, 'cascade_reference',
                          proposals=20)
        if model.roi_head.with_test_masks:
            launches += segm_eval(torch, np, smi, model, work, config,
                                  'cascade_eval', data_cfg)
        del model, base
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    check(launches == CASCADE_LAUNCHES, f'cascade phase: {launches} '
          f'nms_keep launches, expected {CASCADE_LAUNCHES}')
    emit(dict(phase='cascade_done', seconds=time.perf_counter() - t_phase,
              budget_s=75, nms_keep_launches=launches))
    return launches, kernels


def backbone_profile(torch, model, image, iters=1):
    """`iters` forwards of `model.backbone` on `image` under torch.profiler:
    device ops (kernel launches and copies) a forward, device ms, wall ms
    and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model.backbone(image)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model.backbone(image)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return dict(backbone_device_time='not measured')
    return dict(backbone=type(model.backbone).__name__,
                backbone_input=list(image.shape),
                backbone_device_ops_per_forward=sum(
                    e.count for e in kernels) / iters,
                backbone_device_ms=total_us / iters / 1e3,
                backbone_wall_ms=wall_us / iters / 1e3,
                backbone_busy_share=total_us / wall_us)


def phase_hrnet_regnet(torch, np, smi):
    """The HRNet and RegNet detectors at full width, float32, seed 0:
    Faster R-CNN HRNetV2p-W40 (`forward_test` at batch 1 and 2, its
    backbone's launches, steps under the profiler, the card against the
    CPU, a bf16 `forward_test` in the config's own dtype), FCOS
    HRNetV2p-W32 (calls and steps), Mask R-CNN RegNetX-3.2GF (calls at
    batch 1 and 2, steps on the masked batch, the card against the CPU),
    its grouped-DCN variant (steps and one DCN layer against the CPU) and
    RetinaNet RegNetX-800MF (calls). A two-stage model is initialised
    once: `init_detector` serves it from a `.pth` of the trained copy's
    weights, the mdconv model takes the RegNet's weights and seeded DCN
    offsets. Returns the kernel's launch count over the main paths.
    Budget 80 s."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import randomize_dcn_offsets
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_hrnet_regnet')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_cfg = Config.fromfile(os.path.join(ROOT, MASK_DATA_CONFIG))
    image = torch.randn(1, 3, 800, 1344, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(0))
    launches, seconds = 0, {}

    def checkpoint(model, name):
        path = os.path.join(work, name)
        torch.save(model.state_dict(), path)
        return path

    # Faster R-CNN on the widest HRNet
    t = time.perf_counter()
    cfg, base = build_plain(torch, HR_FASTER)
    ckpt = checkpoint(base, 'hrnet_w40.pth')
    model = peak_scores(torch, init_detector(float32_cfg(HR_FASTER), ckpt,
                                             device='cuda'))
    n, _, _ = roi_serve(torch, smi, model, HR_FASTER, 'hrnet_regnet_serve',
                        (1, 2), *HR_SERVE_CALLS)
    launches += n
    emit(dict(phase='hrnet_regnet_backbone', config=HR_FASTER,
              nvidia_smi=smi, **backbone_profile(torch, model, image)))
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *HR_STEPS, per_step=1,
                          phase='hrnet_regnet_train', profile=True)
    launches += n
    roi_reference(torch, np, base, HR_FASTER, 'hrnet_regnet_reference',
                  scaled=True)
    del base
    own = Config.fromfile(os.path.join(ROOT, HR_FASTER))
    check(own.dtype == 'bfloat16', f'{HR_FASTER} dtype {own.dtype}')
    model = peak_scores(torch, init_detector(own, ckpt, device='cuda'))
    check(model.backbone.conv1.compute_dtype == torch.bfloat16 and
          model.neck.reduction_conv.conv.compute_dtype == torch.bfloat16,
          'the bf16 config does not lower HRNet and HRFPN')
    n, _, _ = roi_serve(torch, smi, model, HR_FASTER,
                        'hrnet_regnet_serve_bf16', (1, ), *HR_BF16_CALLS)
    launches += n
    del model
    torch.cuda.empty_cache()
    seconds['faster_rcnn_hrnetv2p_w40'] = time.perf_counter() - t

    # FCOS on HRNetV2p-W32, its HRFPN at stride 2
    t = time.perf_counter()
    n, _ = family_serve(
        torch, smi, HR_FCOS, warmup=HR_FCOS_CALLS[0],
        timed=HR_FCOS_CALLS[1], phase='hrnet_regnet_serve',
        extra=lambda m, bench: backbone_profile(torch, m, bench['image']))
    launches += n
    cfg, base = build_plain(torch, HR_FCOS)
    check(base.neck.fpn_convs[0].conv.stride == (2, 2),
          'the FCOS HRFPN convs are not at stride 2')
    n, _ = detector_steps(torch, smi, cfg, base, *HR_FCOS_STEPS, per_step=0,
                          phase='hrnet_regnet_train')
    launches += n
    del base
    seconds['fcos_hrnetv2p_w32'] = time.perf_counter() - t

    # Mask R-CNN on RegNetX-3.2GF, and its grouped-DCN variant on the same
    # weights with seeded offsets
    t = time.perf_counter()
    cfg, base = build_plain(torch, REG_MASK)
    model = peak_scores(torch, init_detector(
        float32_cfg(REG_MASK), checkpoint(base, 'regnetx_3.2gf.pth'),
        device='cuda'))
    n, _, _ = roi_serve(torch, smi, model, REG_MASK, 'hrnet_regnet_serve',
                        (1, 2), *REG_SERVE_CALLS)
    launches += n
    emit(dict(phase='hrnet_regnet_backbone', config=REG_MASK,
              nvidia_smi=smi, **backbone_profile(torch, model, image)))
    del model
    torch.cuda.empty_cache()
    batch = instance_train_batch(torch, data_cfg)
    n, row = detector_steps(torch, smi, cfg, base, *REG_STEPS, per_step=1,
                            phase='hrnet_regnet_train', batch=batch)
    check(row['loss_last'].get('loss_mask', 0) > 0, 'no RegNet loss_mask')
    launches += n
    roi_reference(torch, np, base, REG_MASK, 'hrnet_regnet_reference')
    seconds['mask_rcnn_regnetx-3.2gf'] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, REG_MDCONV))
    dcn = build_detector(cfg.model)
    missing, unexpected = dcn.load_state_dict(base.state_dict(), strict=False)
    check(not unexpected and missing and
          all('.conv_offset.' in k for k in missing),
          f'mdconv RegNet on the RegNet weights: {missing}, {unexpected}')
    check(randomize_dcn_offsets(dcn, seed=0) == 6 + 15 + 2,
          'the mdconv RegNet has not 23 DCN conv2 layers')
    del base
    n, _ = detector_steps(torch, smi, cfg, dcn, *REG_MDCONV_STEPS,
                          per_step=1, phase='hrnet_regnet_train', batch=batch)
    launches += n
    del dcn, batch
    emit(dict(phase='hrnet_regnet_dcn_layer', config=REG_MDCONV,
              nvidia_smi=smi, **dcn_layer_check(torch, *REG_DCN_LAYER)))
    seconds['mask_rcnn_regnetx-3.2gf_mdconv'] = time.perf_counter() - t

    # RetinaNet on RegNetX-800MF
    t = time.perf_counter()
    n, _ = family_serve(torch, smi, REG_RETINA, warmup=REG_RETINA_CALLS[0],
                        timed=REG_RETINA_CALLS[1],
                        phase='hrnet_regnet_serve')
    launches += n
    seconds['retinanet_regnetx-800mf'] = time.perf_counter() - t
    del image
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    check(launches == HRNET_REGNET_LAUNCHES, f'hrnet_regnet phase: '
          f'{launches} nms_keep launches, expected {HRNET_REGNET_LAUNCHES}')
    emit(dict(phase='hrnet_regnet_done', seconds=time.perf_counter() - t_phase,
              seconds_by_model=seconds, budget_s=80,
              nms_keep_launches=launches))
    return launches


def attention_layer_check(torch, c, heads, kv_stride, hw, batch):
    """One GeneralizedAttention block ('1111') at a full-width c4 shape,
    seeded (gamma 1, so that the attention weighs as much as the input):
    on the card against the CPU on the same weights and input, its output
    and its residual (output minus input) within 1e-4 of their largest
    |value|; its ms, peak memory, and the bytes of one energy tensor."""
    from ld_tpu_torch.models.backbones.plugins import GeneralizedAttention
    layer = GeneralizedAttention(c, num_heads=heads, kv_stride=kv_stride,
                                 attention_type='1111')
    layer.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(batch, c, *hw, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        layer.gamma.fill_(1.0)
        want = layer(x)
        layer = layer.cuda()
        xc = x.cuda()
        got = layer(xc).cpu()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        res_err = float(((got - x) - (want - x)).abs().max())
        res_scale = float((want - x).abs().max())
        check(err <= 1e-4 * scale and res_err <= 1e-4 * res_scale,
              f'attention block: card vs CPU max abs {err} (of {scale}), '
              f'residual {res_err} (of {res_scale})')
        ms, host_ms = cuda_ms(lambda: layer(xc), iters=10, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        layer(xc)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    q = hw[0] * hw[1]
    k = (hw[0] // kv_stride) * (hw[1] // kv_stride)
    row = dict(layer='c4_gen_attention_1111', input=[batch, c, *hw],
               heads=heads, kv_stride=kv_stride, max_abs_err=err,
               max_abs_out=scale, residual_max_abs_err=res_err,
               residual_max_abs=res_scale, ms=ms, host_ms=host_ms,
               peak_bytes_over_input=peak,
               energy_bytes=4 * batch * heads * q * k)
    del layer, x, xc
    torch.cuda.empty_cache()
    return row


def phase_resnet_variants(torch, np, smi):
    """The ResNet's plugins, 'DCN' type and GN + WS at full width, float32,
    seed 0 (each plugin's zero-init gate and each DCN offset conv seeded,
    so that they change the outputs): Mask R-CNN R50 + GCNet (calls at
    batch 1 and 2, masked steps under the profiler, the card against the
    CPU), Faster R-CNN R50 + attention '1111' (calls, steps with the
    attention's share of device time, the card against the CPU, one c4
    attention block against the CPU), Faster R-CNN R50 'DCN' c3-c5
    (calls), Mask R-CNN R50 GN + WS (calls, masked steps under the
    profiler, the card against the CPU), Cascade Mask R-CNN X101-32x4d DCN
    + GCNet (calls). Each model is initialised once, on the CPU, and
    served from a `.pth` of those weights through `init_detector`; the two
    served only, straight from `init_detector`. Returns the kernel's
    launch count over the main paths. Budget 80 s."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import init_detector
    from ld_tpu_torch.models.backbones.plugins import (ContextBlock,
                                                       GeneralizedAttention)
    from ld_tpu_torch.models.layers import ConvWS2d
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    from ld_tpu_torch.testing import (randomize_dcn_offsets,
                                      randomize_plugin_gates)
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_resnet_variants')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_cfg = Config.fromfile(os.path.join(ROOT, MASK_DATA_CONFIG))
    masked = instance_train_batch(torch, data_cfg)
    launches, seconds = 0, {}

    def layer_counts(model):
        """The backbone's ContextBlock, attention, DCN and ConvWS2d
        modules."""
        return tuple(sum(isinstance(m, cls) for m in model.backbone.modules())
                     for cls in (ContextBlock, GeneralizedAttention,
                                 ModulatedDeformConv2d, ConvWS2d))

    def served(config, layers):
        """The config's float32 model from seed 0 on the CPU, its plugin
        gates and DCN offsets seeded, (cfg, base), and the same weights
        served on the card through `init_detector`; `layers` is the
        number of (ContextBlock, GeneralizedAttention, DCN, ConvWS2d)
        modules its backbone must have."""
        cfg, base = build_plain(torch, config)
        randomize_dcn_offsets(base, seed=0)
        randomize_plugin_gates(base, seed=0)
        check(layer_counts(base) == layers, f'{config}: (ContextBlock, '
              f'attention, DCN, ConvWS) layers {layer_counts(base)}, '
              f'expected {layers}')
        path = os.path.join(work, os.path.basename(config)[:-3] + '.pth')
        torch.save(base.state_dict(), path)
        model = peak_scores(torch, init_detector(float32_cfg(config), path,
                                                 device='cuda'))
        return cfg, base, model

    def serve_and_steps(config, layers, batch, range_of=None):
        nonlocal launches
        t = time.perf_counter()
        cfg, base, model = served(config, layers)
        n, _, _ = roi_serve(torch, smi, model, config,
                            'resnet_variants_serve', (1, 2), *RV_CALLS,
                            prof_iters=1)
        launches += n
        del model
        torch.cuda.empty_cache()
        n, row = detector_steps(torch, smi, cfg, base, *RV_STEPS, per_step=1,
                                phase='resnet_variants_train', profile=True,
                                batch=batch, range_of=range_of, prof_steps=1)
        launches += n
        check(batch is None or row['loss_last'].get('loss_mask', 0) > 0,
              f'{config}: no loss_mask')
        roi_reference(torch, np, base, config, 'resnet_variants_reference')
        seconds[os.path.basename(config)[:-3]] = time.perf_counter() - t
        return row

    # R50: 16 blocks, c3-c5 13, c4-c5 9; the GN + WS trunk's convs (the
    # 7x7 stem, 3 a block, 4 shortcuts)
    serve_and_steps(RV_GCB, (13, 0, 0, 0), masked)
    row = serve_and_steps(RV_ATTENTION, (0, 9, 0, 0), None,
                          range_of=GeneralizedAttention)
    check(row.get('module_range_modules') == 9,
          'the attention blocks were not all ranged')
    emit(dict(phase='resnet_variants_attention_layer', nvidia_smi=smi,
              **attention_layer_check(torch, *RV_ATTENTION_LAYER)))
    serve_and_steps(RV_GN_WS, (0, 0, 0, 1 + 3 * 16 + 4), masked)

    # served only: drawn by init_detector, their gates and offsets seeded
    # on the card
    for config, layers, calls, depth in (
            (RV_DCN, (0, 0, 13, 0), RV_DCN_CALLS, None),
            (RV_CASCADE, (13, 0, 13, 0), RV_CASCADE_CALLS, DEPTH_CUT)):
        t = time.perf_counter()
        cfg = float32_cfg(config)
        if depth is not None:
            cfg.model.backbone.depth = depth
        model = init_detector(cfg, device='cuda', seed=0)
        randomize_dcn_offsets(model, seed=0)
        randomize_plugin_gates(model, seed=0)
        check(layer_counts(model) == layers,
              f'{config}: layers {layer_counts(model)}, expected {layers}')
        n, _, _ = roi_serve(torch, smi, peak_scores(torch, model), config,
                            'resnet_variants_serve', (1, ), *calls,
                            prof_iters=1)
        launches += n
        del model
        torch.cuda.empty_cache()
        seconds[os.path.basename(config)[:-3]] = time.perf_counter() - t
    del masked
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    check(launches == RESNET_VARIANTS_LAUNCHES, f'resnet_variants phase: '
          f'{launches} nms_keep launches, expected '
          f'{RESNET_VARIANTS_LAUNCHES}')
    emit(dict(phase='resnet_variants_done',
              seconds=time.perf_counter() - t_phase,
              seconds_by_model=seconds, budget_s=80,
              nms_keep_launches=launches))
    return launches


def loader_steps(torch, smi, cfg, base, loader, warmup, timed, per_step,
                 phase):
    """`warmup` + `timed` training steps of a copy of `base` on the card
    over `loader`'s batches through a DevicePrefetcher (epoch after epoch),
    the config's SGD and schedule: every loss finite and `per_step`
    nms_keep launches a step; a step's ms (the wait for its batch included)
    and the wait alone. Returns the launch count and the emitted row."""
    import copy
    from ld_tpu_torch.data import DevicePrefetcher
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    model = copy.deepcopy(base).to('cuda')
    step, _ = make_step(cfg, model)
    prefetcher = DevicePrefetcher(loader, 'cuda')

    def batches():
        epoch = 0
        while True:
            prefetcher.set_epoch(epoch)
            yield from prefetcher
            epoch += 1
    stream = batches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    config = os.path.relpath(cfg.filename, ROOT)

    # ---- the main path: counts from 0, read right after ------------------
    nms_keep.launches = 0
    step_ms, wait_ms, history, shapes = [], [], [], []
    for i in range(warmup + timed):
        before = nms_keep.launches
        t = time.perf_counter()
        batch = next(stream)
        t_batch = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
            wait_ms.append((t_batch - t) * 1e3)
        shapes.append(list(batch['image'].shape))
        history.append({k: float(v) for k, v in metrics.items()})
        bad = [k for k, v in history[-1].items() if not math.isfinite(v)]
        check(not bad, f'{config} step {i}: non-finite {bad}')
        check(nms_keep.launches - before == per_step,
              f'{config} step {i}: {nms_keep.launches - before} nms_keep '
              f'launches, expected {per_step}')
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    stream.close()
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               detector=type(model).__name__, batch_shapes=shapes,
               warmup_steps=warmup, timed_steps=timed, step_ms=step_ms,
               step_ms_mean=sum(step_ms) / len(step_ms),
               batch_wait_ms=wait_ms, loss_first=history[0],
               loss_last=history[-1], nms_keep_launches=launches,
               nms_keep_launches_per_step=per_step,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    emit(row)
    del model, step, batch
    torch.cuda.empty_cache()
    return launches, row


def pointed(split, ann_file, img_prefix):
    """A dataset config (through its wrappers) reading `ann_file`."""
    import copy
    split = copy.deepcopy(dict(split))
    node = split
    while 'dataset' in node:
        node = node['dataset']
    node.update(ann_file=ann_file, img_prefix=img_prefix)
    return split


def lvis_eval(torch, np, smi, model, cfg, ann, prefix):
    """`eval_detector` -> `evaluate(['bbox', 'segm'])` of the LVIS model
    over the LVIS set's images under the config's test pipeline (batch 2,
    2 launches a batch), and the gts as detections scoring AP 1.0 over the
    1203 classes; returns the launch count."""
    from ld_tpu_torch.apis import eval_detector
    from ld_tpu_torch.data import build_dataset
    from ld_tpu_torch.evaluation.coco_mask import poly_to_mask
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    val = build_dataset(pointed(cfg.data['test'], ann, prefix))
    # ---- the main path (evaluation): counts from 0, read right after -----
    nms_keep.launches = 0
    t = time.perf_counter()
    results = eval_detector(model, val, samples_per_gpu=2, pad_hw=cfg.pad_to)
    eval_s = time.perf_counter() - t
    launches = nms_keep.launches
    # ----------------------------------------------------------------------
    batches = sum(-(-int(n) // 2) for n in np.bincount(val.flag))
    check(launches == 2 * batches,
          f'LVIS eval: {launches} launches for {batches} batches (2 each)')
    check(all(r['masks'].shape == (len(r['boxes']), 28, 28) and
              0 < len(r['boxes']) <= 300 for r in results),
          'LVIS eval results: up to 300 detections an image, with masks')
    t = time.perf_counter()
    metrics = val.evaluate(results, metric=['bbox', 'segm'])
    metric_s = time.perf_counter() - t
    check(all(not math.isfinite(v) or 0 <= v <= 1 for v in metrics.values()),
          f'LVIS evaluate: {metrics}')
    gts = []
    for i, info in enumerate(val.img_infos):
        a = val.get_ann_info(i)
        gts.append(dict(
            boxes=np.concatenate([a['bboxes'], np.ones((len(a['bboxes']),
                                                        1))], 1),
            labels=a['labels'],
            masks=[poly_to_mask(p, info['height'], info['width'])
                   .astype(np.float32) for p in a['masks']]))
    gt_metrics = val.evaluate(gts, metric=['bbox', 'segm'])
    check(gt_metrics['segm_mAP'] == 1.0 and gt_metrics['bbox_mAP'] == 1.0,
          f'LVIS: the gts as detections score {gt_metrics}')
    emit(dict(phase='data_host_lvis_eval', config=LVIS_CONFIG,
              nvidia_smi=smi, images=len(val), classes=len(val.CLASSES),
              eval_detector_s=eval_s, eval_img_per_s=len(val) / eval_s,
              evaluate_s=metric_s, metrics=metrics,
              gt_segm_mAP=gt_metrics['segm_mAP'],
              gt_bbox_mAP=gt_metrics['bbox_mAP'], nms_keep_launches=launches))
    return launches


def host_costs(np, smi):
    """Host ms an 800x1333 uint8 image of the train-time augmentations and
    of each corruption at severity 3 (HOST_COST_CALLS calls each, from one
    seed), on this machine's CPU."""
    import copy
    from ld_tpu_torch import Config
    from ld_tpu_torch.data import CORRUPTIONS, Compose
    rs = np.random.RandomState(0)
    h, w = HOST_COST_HW
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rs.uniform(0, [w * 0.7, h * 0.7], (8, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(20, 300, (8, 2))], -1)
    results = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                   gt_bboxes=boxes.clip(0, [w, h, w, h]).astype(np.float32),
                   gt_labels=rs.randint(0, 80, 8))
    detr = Config.fromfile(os.path.join(ROOT,
                                        'configs/detr/detr_r50_8x2_150e_coco.py'))
    detr_aa = [t for t in detr.data['train']['pipeline']
               if t['type'] == 'AutoAugment']
    mean = [123.675, 116.28, 103.53]
    pipelines = {
        'PhotoMetricDistortion': [dict(type='PhotoMetricDistortion')],
        'Expand+MinIoURandomCrop': [
            dict(type='Expand', mean=mean, to_rgb=True, ratio_range=(1, 4)),
            dict(type='MinIoURandomCrop')],
        'CutOut': [dict(type='CutOut', n_holes=(1, 5),
                        cutout_ratio=(0.1, 0.2))],
        'AutoAugment_detr': detr_aa,
        'AutoAugment_geometric': [dict(type='AutoAugment', policies=[
            [dict(type='Shear', level=6, prob=1.0),
             dict(type='ColorTransform', kind='color', level=6, prob=1.0)],
            [dict(type='Rotate', level=6, prob=1.0),
             dict(type='ColorTransform', kind='equalize', prob=1.0)],
            [dict(type='Translate', level=6, prob=1.0)]])],
    }
    pipelines.update({f'Corrupt_{name}': [dict(
        type='Corrupt', corruption=name, severity=3)] for name in CORRUPTIONS})
    check(len(detr_aa) == 1, 'the DETR config has no AutoAugment')
    np.random.seed(0)
    ms = {}
    for name, cfg in pipelines.items():
        pipe = Compose(copy.deepcopy(cfg))
        times = []
        for _ in range(HOST_COST_CALLS):
            r = copy.deepcopy(results)
            t = time.perf_counter()
            out = pipe(r)
            times.append((time.perf_counter() - t) * 1e3)
            check(out is None or out['img'].ndim == 3, f'{name} output')
        ms[name] = times
    emit(dict(phase='data_host_host_cost', nvidia_smi=smi,
              image=[h, w, 3], calls=HOST_COST_CALLS,
              cpu_count=os.cpu_count(), host_ms=ms,
              host_ms_mean={k: sum(v) / len(v) for k, v in ms.items()}))


def phase_data_host(torch, np, smi):
    """The data layer's host side on the card's machine: LVIS training,
    serving and evaluation through LVISV1Dataset and ClassBalancedDataset,
    the crop640 config's RandomCrop pipeline, the augmentations' and
    corruptions' host cost, and the robustness tool on GFL-R50. Returns the
    kernel's launch count over the main paths. Budget 60 s."""
    from ld_tpu_torch.data import build_dataloader, build_dataset
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.testing import write_coco_instances, write_lvis_instances
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_data_host')
    shutil.rmtree(work, ignore_errors=True)
    launches, seconds = 0, {}

    # LVIS v1: the config's ClassBalancedDataset over LVISV1Dataset
    t = time.perf_counter()
    count, sizes = LVIS_SET
    ann, prefix = write_lvis_instances(os.path.join(work, 'lvis'), count,
                                       sizes=sizes, seed=0)
    cfg, base = build_plain(torch, LVIS_CONFIG)
    train = build_dataset(pointed(cfg.data['train'], ann, prefix))
    check(type(train).__name__ == 'ClassBalancedDataset' and
          len(train.dataset.CLASSES) == 1203 and len(train) == count,
          f'the LVIS train set: {type(train).__name__}, {len(train)} images')
    loader = build_dataloader(train, 2, 1, cfg.pad_to,
                              cfg.max_gts_per_image, seed=0)
    n, row = loader_steps(torch, smi, cfg, base, loader, *LVIS_STEPS,
                          per_step=1, phase='data_host_lvis_train')
    check(row['loss_last'].get('loss_mask', 0) > 0, 'LVIS: no loss_mask')
    launches += n
    model = base.to('cuda').eval()
    n, serve_row, _ = roi_serve(torch, smi, model, LVIS_CONFIG,
                                'data_host_lvis_serve', (1, ), *LVIS_CALLS,
                                prof_iters=1, max_dets=300)
    launches += n
    check(serve_row['nms_k'][1] == 1024,
          f"LVIS: the RoI NMS saw K = {serve_row['nms_k'][1]}, not the "
          'max_candidates cap 1024')
    launches += lvis_eval(torch, np, smi, model, cfg, ann, prefix)
    del model, base, loader, train
    torch.cuda.empty_cache()
    seconds['lvis'] = time.perf_counter() - t

    # the crop640 config through its own RandomCrop pipeline
    t = time.perf_counter()
    count, sizes = CROP_SET
    ann, prefix = write_coco_instances(os.path.join(work, 'crop'), count,
                                       sizes=sizes, seed=1)
    cfg, base = build_plain(torch, CROP_CONFIG)
    train = build_dataset(pointed(cfg.data['train'], ann, prefix))
    check([t['type'] for t in cfg.data['train']['pipeline']][2:5] ==
          ['RandomCrop', 'RandomFlip', 'FusedPreprocess'],
          'the crop640 train pipeline')
    loader = build_dataloader(train, 2, 1, cfg.pad_to,
                              cfg.max_gts_per_image, seed=0)
    n, row = loader_steps(torch, smi, cfg, base, loader, *CROP_STEPS,
                          per_step=1, phase='data_host_crop640_train')
    check(all(s == [2, 3, 640, 640] for s in row['batch_shapes']),
          f"crop640 batches {row['batch_shapes']}")
    launches += n
    del base, loader, train
    torch.cuda.empty_cache()
    seconds['crop640'] = time.perf_counter() - t

    t = time.perf_counter()
    host_costs(np, smi)
    seconds['host_cost'] = time.perf_counter() - t

    # the robustness tool on GFL-R50 (random weights, seed 0)
    t = time.perf_counter()
    count, sizes = ROBUST_SET
    ann, prefix = write_coco_instances(os.path.join(work, 'robust'), count,
                                       sizes=sizes, seed=2)
    tool = load_tool('analysis_tools/test_robustness')
    out = os.path.join(work, 'robustness.json')
    # ---- the main path (the tool's evaluations): counts from 0 -----------
    nms_keep.launches = 0
    res = tool.main([os.path.join(ROOT, CONFIG), '--corruptions',
                     *ROBUST_CORRUPTIONS, '--severities',
                     str(ROBUST_SEVERITY), '--out', out, '--cfg-options',
                     'dtype=float32', f'data.test.ann_file={ann}',
                     f'data.test.img_prefix={prefix}'])
    n = nms_keep.launches
    # ----------------------------------------------------------------------
    runs = len(ROBUST_CORRUPTIONS) + 1
    check(n == runs * 2, f'robustness tool: {n} launches for {runs} runs '
          'of 2 eval batches')
    with open(out) as f:
        summary = load_tool('analysis_tools/robustness_eval').summarize(
            json.load(f))
    check(sorted(res['results']) == sorted(ROBUST_CORRUPTIONS) and
          all(math.isfinite(v) for v in res['summary'].values()),
          f"robustness results {res['summary']}")
    launches += n
    seconds['robustness'] = time.perf_counter() - t
    emit(dict(phase='data_host_robustness', config=CONFIG, nvidia_smi=smi,
              images=count, corruptions=list(ROBUST_CORRUPTIONS),
              severity=ROBUST_SEVERITY, summary=res['summary'],
              metrics=summary[0], P=summary[1].tolist(),
              mPC=summary[2].tolist(), nms_keep_launches=n,
              seconds=seconds['robustness']))
    shutil.rmtree(work, ignore_errors=True)
    check(launches == DATA_HOST_LAUNCHES, f'data_host phase: {launches} '
          f'nms_keep launches, expected {DATA_HOST_LAUNCHES}')
    emit(dict(phase='data_host_done', seconds=time.perf_counter() - t_phase,
              seconds_by_part=seconds, budget_s=60,
              nms_keep_launches=launches))
    return launches


def module_share(torch, model, bench, cls, name):
    """One profiled `forward_test` call of `model` on `bench`: its device
    time, busy share and device ops, and the share of its device time
    that the forwards of its `cls` modules launch (a `record_function`
    range named `name` around each)."""
    from torch.profiler import ProfilerActivity, profile
    with module_ranges(model, cls, name) as n_modules, \
            torch.inference_mode():
        model.forward_test(bench)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model.forward_test(bench)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda and e.key != name]
    total_us = sum(e.self_device_time_total for e in kernels)
    ranged = [e for e in events if e.key == name and e.device_type != cuda]
    range_us = sum(e.device_time_total for e in ranged)
    out = {f'{name}_modules': n_modules,
           f'{name}_calls_per_forward': sum(e.count for e in ranged)}
    if total_us <= 0:
        out['device_time'] = 'not measured'
        return out
    out.update({'device_ms_per_call': total_us / 1e3,
                'wall_ms_per_call_profiled': wall_us / 1e3,
                'device_busy_share': total_us / wall_us,
                'device_ops_per_call': sum(e.count for e in kernels),
                f'{name}_device_ms_per_call': range_us / 1e3
                if range_us > 0 else 'not measured',
                f'{name}_device_share': range_us / total_us
                if range_us > 0 else 'not measured'})
    return out


def deform_conv_share(torch, model, bench, name='star_dcn'):
    """One profiled `forward_test` call: its device time, busy share and
    device ops, and the share of the device time that the head's
    caller-offset DeformConv calls launch (VFNet's star DCN; GA's
    adaptions, RepPoints' point DCNs under their own `name`: a
    `record_function` range around each, `module_share`), with the HBM
    bound of their gathers (four corner reads and the columns' write,
    float32)."""
    from ld_tpu_torch.ops.deform_conv import DeformConv
    cols = []

    def count(module, args, out):
        b, _, oh, ow = out.shape
        cols.append(b * oh * ow * 9 * module.in_channels)
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, DeformConv)]
    try:
        out = module_share(torch, model, bench, DeformConv, name)
    finally:
        for h in hooks:
            h.remove()
    # a warm-up call, then the profiled one: the second half of the counts
    out[f'{name}_gather_bound_ms'] = sum(
        5 * 4 * n for n in cols[len(cols) // 2:]) / PEAK_HBM_BYTES * 1e3
    return out


def serve_b2(torch, smi, base, config, phase, warmup, timed):
    """`forward_test` of a single-stage model at batch 2, 800x1344: 1
    launch a call; returns the launch count."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    bench = dict(image=torch.randn(2, 3, 800, 1344, device='cuda',
                                   generator=torch.Generator('cuda')
                                   .manual_seed(1)),
                 img_hw=torch.tensor([[800.0, 1344.0]] * 2, device='cuda'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        for _ in range(warmup):
            base.forward_test(bench)
        torch.cuda.synchronize()
        call_ms = []
        for _ in range(timed):
            t = time.perf_counter()
            dets, _, valid = base.forward_test(bench)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t) * 1e3)
        launches = nms_keep.launches
        # ------------------------------------------------------------------
    check(launches == warmup + timed, f'{config} batch 2: {launches} '
          f'launches for {warmup + timed} calls')
    check(tuple(dets.shape) == (2, 100, 5) and
          bool(torch.isfinite(dets).all()) and bool(valid.any(1).all()),
          f'{config} forward_test at batch 2')
    emit(dict(phase=phase, config=config, nvidia_smi=smi,
              input=[2, 3, 800, 1344], warmup_calls=warmup,
              timed_calls=timed, forward_test_ms=call_ms,
              forward_test_ms_mean=sum(call_ms) / len(call_ms),
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
              nms_keep_launches=launches, detections=int(valid.sum())))
    return launches


def vfnet_reference(torch, np, cfg, base):
    """VFNet at 1x3x128x192 on the card against the CPU: the head's three
    outputs (5e-3 / 2e-4), the first step's losses (rtol 1e-3 a term), the
    decode of the CPU's outputs on both (labels, valid and kept set equal,
    boxes and scores within 1e-4), and the two devices' own detections
    (reported)."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    worst, worst_med = outputs_reference(torch, np, base)
    phase_train_reference(torch, cfg, base, gi=False,
                          phase='vfnet_train_reference')
    batch = detection_batch(1, 128, 192, seed=0, device='cpu')
    cpu = copy.deepcopy(base).eval()
    card = copy.deepcopy(base).to('cuda').eval()
    with torch.inference_mode():
        outs = cpu(batch['image'])
        want = cpu.bbox_head.get_bboxes(outs, batch['img_hw'])
        got = card.bbox_head.get_bboxes(
            [[x.cuda() for x in part] for part in outs],
            batch['img_hw'].cuda())
        got = [x.cpu() for x in got]
        own = [x.cpu() for x in card.forward_test(
            {k: v.cuda() for k, v in batch.items()})]
    valid = want[2]
    diff = float((got[0] - want[0])[valid].abs().max())
    check(int(valid.sum()) > 0 and torch.equal(got[2], valid) and
          torch.equal(got[1], want[1]) and diff <= 1e-4,
          f'VFNet decode of the same outputs: card vs CPU, {diff}')
    emit(dict(phase='vfnet_reference', config=VFNET_CONFIG,
              input='1x3x128x192', max_abs_diff=worst, tol_abs=5e-3,
              max_median_rel_diff=worst_med, tol_median_rel=2e-4,
              decode_detections=int(valid.sum()), decode_max_abs_diff=diff,
              decode_tol=1e-4, detections_cpu=int(valid.sum()),
              detections_card=int(own[2].sum()),
              top_score_cpu=float(want[0][0, 0, 4]),
              top_score_card=float(own[0][0, 0, 4]),
              card_match_share=match_share(torch, want, own)))
    del card
    torch.cuda.empty_cache()


def phase_vfnet(torch, np, smi):
    """VarifocalNet at full width, float32, seed 0: the R50 config served
    at batch 1 (with the star DCN's device share) and 2, trained at batch
    2, and held against the CPU; the widest config served at batch 1.
    Returns the kernel's launch count over the main paths. Budget 60 s."""
    t_phase = time.perf_counter()
    launches = 0
    n, _ = family_serve(torch, smi, VFNET_CONFIG, None, *VFNET_CALLS,
                        phase='vfnet_serve',
                        extra=dense_dcn_extra(torch, 'star_dcn', 10))
    launches += n
    cfg, base = build_plain(torch, VFNET_CONFIG)
    with torch.no_grad():
        base.bbox_head.vfnet_cls.bias.zero_()
    model = base.to('cuda').eval()
    launches += serve_b2(torch, smi, model, VFNET_CONFIG, 'vfnet_serve_b2',
                         *VFNET_CALLS_B2)
    base = model.cpu()
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *VFNET_STEPS, per_step=0,
                          phase='vfnet_train', profile=True, prof_steps=1)
    launches += n
    vfnet_reference(torch, np, cfg, base)
    del base
    n, _ = family_serve(torch, smi, VFNET_WIDE, DEPTH_CUT, *VFNET_WIDE_CALLS,
                        phase='vfnet_wide_serve')
    launches += n
    torch.cuda.empty_cache()
    check(launches == VFNET_LAUNCHES, f'vfnet phase: {launches} nms_keep '
          f'launches, expected {VFNET_LAUNCHES}')
    emit(dict(phase='vfnet_done', seconds=time.perf_counter() - t_phase,
              budget_s=60, nms_keep_launches=launches))
    return launches


def seed_dense_offsets(torch, model):
    """The convs that place a GA or RepPoints head's DeformConv taps seeded
    off the grid (`randomize_head_offsets`), and GA's location logit at 0,
    so that every location passes the 0.01 filter; returns the number of
    seeded convs."""
    from ld_tpu_torch.testing import randomize_head_offsets
    head = getattr(model, 'bbox_head', None) or model.rpn_head
    n = randomize_head_offsets(head, seed=0)
    check(n > 0, f'{type(head).__name__}: no offset conv seeded')
    if hasattr(head, 'conv_loc'):
        with torch.no_grad():
            head.conv_loc.bias.zero_()
    return n


def seeded_plain(torch, config):
    """`build_plain` with the offsets seeded, the class and location
    biases at 0; returns (cfg, model)."""
    cfg, base = build_plain(torch, config)
    seed_dense_offsets(torch, base)
    head = getattr(base, 'bbox_head', None)
    if head is not None:
        with torch.no_grad():
            getattr(head, head.cls_pred_name).bias.zero_()
    return cfg, base


def dense_dcn_extra(torch, name, per_forward, modules=2):
    """family_serve's `extra`: the head's DeformConv share of one profiled
    call under `name`, `per_forward` DCN calls a forward."""
    from ld_tpu_torch.ops.deform_conv import DeformConv

    def extra(model, bench):
        check(sum(isinstance(m, DeformConv) for m in model.modules()) ==
              modules, f'{name}: {modules} DeformConv modules')
        row = deform_conv_share(torch, model, bench, name=name)
        calls = row[f'{name}_calls_per_forward']
        check(calls == per_forward, f'{name}: {calls} DeformConv calls a '
              f'forward, expected {per_forward}')
        return row
    return extra


def decode_reference(torch, base, phase, config, hw=(128, 192)):
    """The decode of the CPU's outputs at 1x3x128x192 on the card against
    the CPU: a dense head's detections (labels, valid and kept set equal,
    boxes and scores within 1e-4), or a GA-RPN's proposals (valid equal,
    boxes within 1e-4); one nms_keep launch on the card."""
    import copy
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(1, *hw, seed=0, device='cpu')
    cpu = copy.deepcopy(base).eval()
    card = copy.deepcopy(base).to('cuda').eval()
    two_stage = hasattr(cpu, 'rpn_head')
    with torch.inference_mode():
        outs = cpu(batch['image'])
        if two_stage:
            outs = outs[1]
            want = cpu.rpn_head.get_proposals(outs, batch['img_hw'])
            decode = card.rpn_head.get_proposals
        else:
            want = cpu.bbox_head.get_bboxes(outs, batch['img_hw'])
            decode = card.bbox_head.get_bboxes
        before = nms_keep.launches
        got = decode([[x.cuda() for x in part] for part in outs],
                     batch['img_hw'].cuda())
        torch.cuda.synchronize()
        launched = nms_keep.launches - before
        got = [x.cpu() for x in got]
    valid = want[-1]
    diff = float((got[0] - want[0])[valid].abs().max())
    check(launched == 1, f'{config} decode: {launched} launches')
    check(int(valid.sum()) > 0 and torch.equal(got[-1], valid) and
          (two_stage or torch.equal(got[1], want[1])) and diff <= 1e-4,
          f'{config} decode of the same outputs: card vs CPU, {diff}')
    emit(dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
              decoded=int(valid.sum()), decode_max_abs_diff=diff,
              decode_tol=1e-4, nms_keep_launches_reference=launched))
    del card
    torch.cuda.empty_cache()


def ga_rpn_serve(torch, smi, warmup, timed):
    """GA-RPN R50's `forward_test` (its proposals) at batch 1, 800x1344: 1
    launch a call at K = nms_pre, the proposals identical with the plain
    keep mask, the adaption DCN's share of one profiled call; returns the
    launch count."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    _, base = seeded_plain(torch, GA_RPN)
    model = base.to('cuda').eval()
    bench = dict(image=torch.randn(1, 3, 800, 1344, device='cuda',
                                   generator=torch.Generator('cuda')
                                   .manual_seed(0)),
                 img_hw=torch.tensor([[800.0, 1344.0]], device='cuda'))
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
        check(launches == warmup + timed, f'{GA_RPN}: {launches} launches '
              f'for {warmup + timed} calls')
        check(bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0,
              f'{GA_RPN}: forward_test proposals')
        _, rpn_outs = model(bench['image'])
        captured = []

        def capture(boxes, valid, thr):
            captured.append(tuple(boxes.shape))
            return nms_keep(boxes, valid, thr)
        got = model.rpn_head.get_proposals(rpn_outs, bench['img_hw'],
                                           keep_fn=capture)
        want = model.rpn_head.get_proposals(rpn_outs, bench['img_hw'],
                                            keep_fn=nms_keep_ref)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f'{GA_RPN}: proposals with the kernel differ from the plain '
              'keep mask')
        # the two adaptions at strides 4-64: P2's columns 619 MB a call
        share = dense_dcn_extra(torch, 'adaption_dcn', 10)(model, bench)
    emit(dict(phase='ga_rpn_serve', config=GA_RPN, nvidia_smi=smi,
              input=[1, 3, 800, 1344], warmup_calls=warmup,
              timed_calls=timed, forward_test_ms=call_ms,
              forward_test_ms_mean=sum(call_ms) / len(call_ms),
              max_memory_allocated_bytes=peak, nms_keep_launches=launches,
              nms_k=captured[0][1], proposals=int(valid.sum()),
              plain_keep_identical=True, **share))
    del model, base, rpn_outs
    torch.cuda.empty_cache()
    return launches


def phase_guided_anchoring(torch, np, smi):
    """Guided Anchoring at full width, float32, seed 0 (the adaptions'
    offset convs seeded off the grid, the class and location biases 0):
    GA-RetinaNet R50 served at batch 1 (with the adaption DCN's device
    share) and 2, trained at batch 2, held against the CPU; GA-Faster
    R-CNN R50 served at batch 1 (the K of each NMS) and trained at batch 2
    (peak memory: its ApproxMaxIoU at strides 4-64), held against the CPU,
    its fc_cls peaked (`peak_scores`) for serving; GA-RPN R50 served. Returns the kernel's launch count over the main
    paths. Budget 45 s."""
    import copy
    from ld_tpu_torch.models.heads import GARPNHead
    t_phase = time.perf_counter()
    launches = 0
    n, _ = family_serve(torch, smi, GA_RETINA, None, *GA_CALLS,
                        phase='ga_retina_serve',
                        prepare=lambda m: seed_dense_offsets(torch, m),
                        extra=dense_dcn_extra(torch, 'adaption_dcn', 10))
    launches += n
    cfg, base = seeded_plain(torch, GA_RETINA)
    model = base.to('cuda').eval()
    launches += serve_b2(torch, smi, model, GA_RETINA, 'ga_retina_serve_b2',
                         *GA_CALLS_B2)
    base = model.cpu()
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *GA_STEPS, per_step=0,
                          phase='ga_retina_train')
    launches += n
    worst, worst_med = outputs_reference(torch, np, base)
    emit(dict(phase='ga_retina_reference', config=GA_RETINA,
              input='1x3x128x192', max_abs_diff=worst, tol_abs=5e-3,
              max_median_rel_diff=worst_med, tol_median_rel=2e-4))
    phase_train_reference(torch, cfg, base, gi=False,
                          phase='ga_retina_train_reference')
    decode_reference(torch, base, 'ga_retina_decode_reference', GA_RETINA)
    del base

    cfg, base = seeded_plain(torch, GA_FASTER)
    check(isinstance(base.rpn_head, GARPNHead), 'GA-Faster: a GA-RPN')
    model = peak_scores(torch, copy.deepcopy(base)).to('cuda').eval()
    n, row, _ = roi_serve(torch, smi, model, GA_FASTER, 'ga_faster_serve',
                          batches=(1, ), warmup=GA_FASTER_CALLS[0],
                          timed=GA_FASTER_CALLS[1], prof_iters=1)
    launches += n
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *GA_FASTER_STEPS,
                          per_step=1, phase='ga_faster_train')
    launches += n
    roi_reference(torch, np, base, GA_FASTER, 'ga_faster_reference')
    decode_reference(torch, base, 'ga_faster_proposals_reference',
                     GA_FASTER)
    del base
    launches += ga_rpn_serve(torch, smi, *GA_RPN_CALLS)
    torch.cuda.empty_cache()
    check(launches == GA_LAUNCHES, f'guided_anchoring phase: {launches} '
          f'nms_keep launches, expected {GA_LAUNCHES}')
    emit(dict(phase='guided_anchoring_done',
              seconds=time.perf_counter() - t_phase, budget_s=45,
              nms_keep_launches=launches, ga_faster_nms_k=row['nms_k']))
    return launches


def phase_reppoints(torch, np, smi):
    """RepPoints at full width, float32, seed 0 (the init points seeded off
    the grid, the class bias 0): the moment R50 config served at batch 1
    (with the point DCNs' device share) and 2, trained at batch 2 and held
    against the CPU; the grid config served, trained one step and held
    against the CPU; the widest config (X101 with DCNv2 in c3-c5) served.
    Returns the kernel's launch count over the main paths. Budget 45 s."""
    t_phase = time.perf_counter()
    launches = 0

    def prepare(m):
        return seed_dense_offsets(torch, m)
    for config, calls, steps in ((RP_MOMENT, RP_CALLS, RP_STEPS),
                                 (RP_GRID, RP_GRID_CALLS, RP_GRID_STEPS)):
        tag = 'rp_moment' if config == RP_MOMENT else 'rp_grid'
        n, _ = family_serve(torch, smi, config, None, *calls,
                            phase=f'{tag}_serve', prepare=prepare,
                            extra=dense_dcn_extra(torch, 'points_dcn', 10)
                            if config == RP_MOMENT else None)
        launches += n
        cfg, base = seeded_plain(torch, config)
        if config == RP_MOMENT:
            model = base.to('cuda').eval()
            launches += serve_b2(torch, smi, model, config,
                                 f'{tag}_serve_b2', *RP_CALLS_B2)
            base = model.cpu()
            del model
            torch.cuda.empty_cache()
        n, _ = detector_steps(torch, smi, cfg, base, *steps, per_step=0,
                              phase=f'{tag}_train')
        launches += n
        worst, worst_med = outputs_reference(torch, np, base)
        emit(dict(phase=f'{tag}_reference', config=config,
                  input='1x3x128x192', max_abs_diff=worst, tol_abs=5e-3,
                  max_median_rel_diff=worst_med, tol_median_rel=2e-4))
        phase_train_reference(torch, cfg, base, gi=False,
                              phase=f'{tag}_train_reference')
        decode_reference(torch, base, f'{tag}_decode_reference', config)
        del base
    n, _ = family_serve(torch, smi, RP_WIDE, DEPTH_CUT, *RP_WIDE_CALLS,
                        phase='rp_wide_serve', prepare=prepare)
    launches += n
    torch.cuda.empty_cache()
    check(launches == RP_LAUNCHES, f'reppoints phase: {launches} nms_keep '
          f'launches, expected {RP_LAUNCHES}')
    emit(dict(phase='reppoints_done', seconds=time.perf_counter() - t_phase,
              budget_s=45, nms_keep_launches=launches))
    return launches


def ssd_serve(torch, smi, config, base, calls, phase):
    """`forward_test` of an SSD `base` (moved to the card and back) at its
    input size, (warm-up, timed) `calls` at each batch size of the dict in
    turn: 1 launch a call at K = 1024 of
    its anchors x 80 classes, 200 detections an image, at the largest
    batch the detections identical with the plain keep mask and the first
    one's score the largest foreground softmax probability. Returns the
    launch count."""
    import torch.nn.functional as F
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    size = base.backbone.input_size
    model = base.to('cuda').eval()
    head = model.bbox_head
    gen = torch.Generator('cuda').manual_seed(0)
    benches = {b: dict(image=torch.randn(b, 3, size, size, device='cuda',
                                         generator=gen),
                       img_hw=torch.tensor([[float(size)] * 2] * b,
                                           device='cuda'))
               for b in calls}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_ms = {}
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        for b, bench in benches.items():
            warmup, timed = calls[b]
            for _ in range(warmup):
                model.forward_test(bench)
            torch.cuda.synchronize()
            times = []
            for _ in range(timed):
                t = time.perf_counter()
                dets, _, valid = model.forward_test(bench)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            call_ms[b] = times
            check(tuple(dets.shape) == (b, 200, 5) and
                  bool(torch.isfinite(dets).all()) and
                  bool(valid.any(1).all()),
                  f'{config} forward_test at batch {b}')
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        n_calls = sum(sum(c) for c in calls.values())
        check(launches == n_calls, f'{config}: {launches} launches for '
              f'{n_calls} calls')
        bench = benches[max(calls)]
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
        cls, _ = head._flatten(*outs)
        best = float(F.softmax(cls[0], dim=-1)[:, :head.num_classes].max())
        check(abs(float(got[0][0, 0, 4]) - best) <= 1e-6,
              f'{config}: first detection score {float(got[0][0, 0, 4])} '
              f'is not the largest class probability {best}')
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               anchors=int(cls.shape[1]), input_size=size,
               calls={str(b): c for b, c in calls.items()},
               max_memory_allocated_bytes=peak, nms_keep_launches=launches,
               nms_k=captured[0][0][1], nms_valid_candidates=captured[0][1],
               detections=int(got[2].sum()), top_score=best,
               plain_keep_identical=True)
    for b, times in call_ms.items():
        row[f'forward_test_ms_b{b}'] = times
        row[f'forward_test_ms_b{b}_mean'] = sum(times) / len(times)
    emit(row)
    base = model.cpu()
    del model, outs, benches, bench
    torch.cuda.empty_cache()
    return launches


def dense_reference(torch, np, cfg, base, config, phase, hw=(128, 192)):
    """A single-stage model at 1x3x`hw` on the card against the CPU: the
    head outputs (5e-3 / 2e-4), the first step's losses (rtol 1e-3 a
    term), the decode of the CPU's outputs (the same kept set, boxes
    within 1e-4)."""
    worst, worst_med = outputs_reference(torch, np, base, hw=hw)
    emit(dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
              max_abs_diff=worst, tol_abs=5e-3, max_median_rel_diff=worst_med,
              tol_median_rel=2e-4))
    phase_train_reference(torch, cfg, base, gi=False,
                          phase=f'{phase}_train', hw=hw)
    decode_reference(torch, base, f'{phase}_decode', config, hw=hw)


def phase_fovea_ssd(torch, np, smi):
    """FoveaBox and SSD at full width, float32, seed 0: FoveaBox R50 served
    at batch 1 and 2 and trained at batch 2; FoveaBox-align R50 (its offset
    conv seeded off the grid) served at batch 1 with the align DCN's device
    share, trained at batch 2; FoveaBox-align R101 served; SSD300 served at
    batch 1 and 8 and trained at batch 8; SSD512 served at batch 1 and
    trained at batch 8; each R50 FoveaBox and SSD300 held against the CPU.
    Returns the kernel's launch count over the main paths. Budget 40 s."""
    t_phase = time.perf_counter()
    launches = 0
    n, _ = family_serve(torch, smi, FOVEA, None, *FOVEA_CALLS,
                        phase='fovea_serve')
    launches += n
    cfg, base = build_plain(torch, FOVEA)
    with torch.no_grad():
        base.bbox_head.conv_cls.bias.zero_()
    model = base.to('cuda').eval()
    launches += serve_b2(torch, smi, model, FOVEA, 'fovea_serve_b2',
                         *FOVEA_CALLS_B2)
    base = model.cpu()
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *FOVEA_STEPS, per_step=0,
                          phase='fovea_train')
    launches += n
    dense_reference(torch, np, cfg, base, FOVEA, 'fovea_reference')
    del base

    def prepare(m):
        return seed_dense_offsets(torch, m)
    n, _ = family_serve(torch, smi, FOVEA_ALIGN, None, *ALIGN_CALLS,
                        phase='fovea_align_serve', prepare=prepare,
                        extra=dense_dcn_extra(torch, 'align_dcn', 5,
                                              modules=1))
    launches += n
    cfg, base = seeded_plain(torch, FOVEA_ALIGN)
    n, _ = detector_steps(torch, smi, cfg, base, *ALIGN_STEPS, per_step=0,
                          phase='fovea_align_train')
    launches += n
    dense_reference(torch, np, cfg, base, FOVEA_ALIGN,
                    'fovea_align_reference')
    del base
    n, _ = family_serve(torch, smi, FOVEA_ALIGN_R101, DEPTH_CUT,
                        *ALIGN_R101_CALLS, phase='fovea_align_r101_serve',
                        prepare=prepare)
    launches += n

    for config, calls, steps in (
            (SSD300, {1: SSD300_CALLS, 8: SSD300_CALLS_B8}, SSD300_STEPS),
            (SSD512, {1: SSD512_CALLS}, SSD512_STEPS)):
        tag = os.path.basename(config)[:6]
        cfg, base = build_plain(torch, config)
        launches += ssd_serve(torch, smi, config, base, calls, f'{tag}_serve')
        size = base.backbone.input_size
        n, _ = detector_steps(torch, smi, cfg, base, *steps, per_step=0,
                              phase=f'{tag}_train', batch_size=8,
                              pad=(size, size))
        launches += n
        if config == SSD300:
            dense_reference(torch, np, cfg, base, config, 'ssd300_reference',
                            hw=(300, 300))
        del base
        torch.cuda.empty_cache()
    check(launches == FOVEA_SSD_LAUNCHES, f'fovea_ssd phase: {launches} '
          f'nms_keep launches, expected {FOVEA_SSD_LAUNCHES}')
    emit(dict(phase='fovea_ssd_done', seconds=time.perf_counter() - t_phase,
              budget_s=40, nms_keep_launches=launches))
    return launches


def masked_batch(torch, np, batch_size=2, hw=(800, 1344)):
    """A seeded detection batch of 80 classes with box-region gt masks
    (`box_masks`), on the card."""
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(batch_size, *hw, num_classes=80, seed=0,
                            device='cpu')
    batch['gt_masks'] = box_masks(torch, np, batch)
    return {k: v.to('cuda') for k, v in batch.items()}


def bn_change(torch, base):
    """detector_steps' `inspect` of a trunk with live BNs: the BNs in
    training mode after the steps, and how far their running statistics
    moved from `base`'s (the frozen ones must not move)."""
    def inspect(model):
        before = base.backbone.state_dict()
        after = {k: v.cpu() for k, v in model.backbone.state_dict().items()}
        live = [n for n, m in model.backbone.named_modules()
                if isinstance(m, torch.nn.BatchNorm2d) and m.training]
        frozen = [n for n, m in model.backbone.named_modules()
                  if isinstance(m, torch.nn.BatchNorm2d) and not m.training]
        moved = {s: max(float((after[f'{n}.running_{s}'] -
                               before[f'{n}.running_{s}']).abs().max())
                        for n in live) for s in ('mean', 'var')}
        still = all(torch.equal(after[f'{n}.running_{s}'],
                                before[f'{n}.running_{s}'])
                    for n in frozen for s in ('mean', 'var'))
        check(live and moved['mean'] > 0 and still,
              f'live BNs: {len(live)} live, moved {moved}, frozen '
              f'unchanged {still}')
        return dict(bns_live=len(live), bns_frozen=len(frozen),
                    running_mean_max_change=moved['mean'],
                    running_var_max_change=moved['var'],
                    frozen_bns_unchanged=still)
    return inspect


def resnest_train_reference(torch, np, base, config, phase):
    """A ResNeSt detector's first losses in training (its BNs live) at
    2x3x128x192, card against CPU, with samplers that pick every candidate
    and the RoI losses on the CPU's proposals: with the trunk in float64 on
    both devices, rtol 1e-3 a term; in float32, reported only. Each live
    `bn1` over the pooled map's 2 values amplifies rounding through the
    stages (the CPU tests found a float32 trunk's last stage 0.08 from the
    float64 one at batch 2)."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    runs = {}
    for trunk64 in (True, False):
        props = None
        for device in ('cpu', 'cuda'):
            model = sample_everything(copy.deepcopy(base)).to(device).train()
            batch = detection_batch(2, 128, 192, seed=0, device=device)
            if trunk64:
                model.backbone.double()
                model.backbone.register_forward_hook(
                    lambda m, args, outs: tuple(o.float() for o in outs))
                batch['image'] = batch['image'].double()
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.no_grad():
                feats, rpn_outs = model(batch['image'])
                sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
                losses = model.rpn_head.loss(rpn_outs, batch, sizes, gen)
                if props is None:
                    props = model._proposals(rpn_outs, batch['img_hw'])
                losses.update(model.roi_head.forward_train(
                    feats, *(p.to(device) for p in props), batch, gen))
            runs[trunk64, device] = {k: float(v) for k, v in losses.items()}
            del model, feats, rpn_outs
    rel = {t: {k: abs(runs[t, 'cuda'][k] - c) / abs(c)
               for k, c in runs[t, 'cpu'].items() if c} for t in (True, False)}
    emit(dict(phase=phase, config=config, input='2x3x128x192',
              loss_cpu=runs[True, 'cpu'], loss_card=runs[True, 'cuda'],
              rel_diff_trunk_float64=rel[True], rtol=1e-3,
              rel_diff_trunk_float32=rel[False],
              loss_cpu_trunk_float32=runs[False, 'cpu']))
    for k, r in rel[True].items():
        check(r <= 1e-3, f'{config} {k} (trunk in float64): card vs CPU '
              f'{r} beyond rtol 1e-3')
    torch.cuda.empty_cache()


def phase_ms_rcnn_resnest(torch, np, smi):
    """Mask Scoring R-CNN and the ResNeSt detectors at full width, float32,
    seed 0 (fc_cls peaked, `peak_scores`, for serving): MS R-CNN R50 served
    at batch 1 and 2 with masks, trained at batch 2 with box-region gt
    masks (`loss_mask_iou`), held against the CPU; MS R-CNN X101-64x4d
    served; the ResNeSt-50 Faster R-CNN served at batch 1 and 2, trained at
    batch 2 with its BNs live (their running statistics' change
    reported), held against the CPU; Cascade Mask R-CNN S101 served at
    batch 1 and trained at batch 2. Returns the kernel's launch count over
    the main paths. Budget 50 s."""
    import copy
    t_phase = time.perf_counter()
    launches = 0
    cfg, base = build_plain(torch, MS_RCNN)
    model = peak_scores(torch, copy.deepcopy(base)).to('cuda').eval()
    n, _, _ = roi_serve(torch, smi, model, MS_RCNN, 'ms_rcnn_serve',
                        warmup=MS_CALLS[0], timed=MS_CALLS[1], prof_iters=1)
    launches += n
    del model
    torch.cuda.empty_cache()
    n, row = detector_steps(torch, smi, cfg, base, *MS_STEPS, per_step=1,
                            phase='ms_rcnn_train',
                            batch=masked_batch(torch, np))
    launches += n
    check(row['loss_first'].get('loss_mask_iou', 0) > 0,
          f'{MS_RCNN}: no loss_mask_iou in {sorted(row["loss_first"])}')
    roi_reference(torch, np, base, MS_RCNN, 'ms_rcnn_reference')
    del base
    for config, calls, steps in ((MS_X101, MS_X101_CALLS, None),
                                 (S50_FASTER, S50_CALLS, S50_STEPS),
                                 (S101_CASCADE, S101_CALLS, S101_STEPS)):
        tag = {MS_X101: 'ms_x101', S50_FASTER: 's50_faster',
               S101_CASCADE: 's101_cascade_mask'}[config]
        cfg, base = build_plain(torch, config, depth=None
                                if config == S50_FASTER else DEPTH_CUT)
        model = peak_scores(torch, copy.deepcopy(base)).to('cuda').eval()
        n, _, _ = roi_serve(torch, smi, model, config, f'{tag}_serve',
                            batches=(1, 2) if config == S50_FASTER else (1, ),
                            warmup=calls[0], timed=calls[1], prof_iters=1)
        launches += n
        del model
        torch.cuda.empty_cache()
        if steps is not None:
            live = config != MS_X101
            n, _ = detector_steps(
                torch, smi, cfg, base, *steps, per_step=1,
                phase=f'{tag}_train',
                batch=masked_batch(torch, np)
                if base.roi_head.with_test_masks else None,
                inspect=bn_change(torch, base) if live else None)
            launches += n
        if config == S50_FASTER:
            worst, worst_med = outputs_reference(torch, np, base)
            emit(dict(phase='s50_faster_outputs_reference', config=config,
                      input='1x3x128x192', max_abs_diff=worst, tol_abs=5e-3,
                      max_median_rel_diff=worst_med, tol_median_rel=2e-4))
            resnest_train_reference(torch, np, base, config,
                                    's50_faster_train_reference')
        del base
        torch.cuda.empty_cache()
    check(launches == MS_RESNEST_LAUNCHES, f'ms_rcnn_resnest phase: '
          f'{launches} nms_keep launches, expected {MS_RESNEST_LAUNCHES}')
    emit(dict(phase='ms_rcnn_resnest_done',
              seconds=time.perf_counter() - t_phase, budget_s=50,
              nms_keep_launches=launches))
    return launches


def paa_gmm(torch):
    """`detector_steps`' `inspect` for PAA: on the stepped model's outputs
    of the step batch (2x3x800x1344, seed 0), the reassignment's sizes and
    its pieces' times: `fit_gmm_1d` alone (CUDA-event ms of 20 calls and
    device ms from the profiler over 3), the whole `reassign` (smallest-k,
    GMM, ranks) and the head's `reassigned` (assignment, decode and the
    per-anchor losses too)."""
    from torch.profiler import ProfilerActivity, profile
    from ld_tpu_torch.models.heads.paa_head import BIG, fit_gmm_1d
    from ld_tpu_torch.testing import detection_batch

    def inspect(model):
        head = model.bbox_head
        batch = detection_batch(2, 800, 1344, num_classes=80, seed=0,
                                device='cuda')
        with torch.no_grad():
            outs = model(batch['image'])
            sizes = [tuple(c.shape[-2:]) for c in outs[0]]
            r = head.reassigned(outs, batch, sizes)
            num_gt = batch['gt_bboxes'].shape[1]
            args = (r['pos_loss'], r['cand'], r['gt_inds'], r['level_id'],
                    num_gt)
            x, aidx = head.candidate_losses(*args)
            xv = x < BIG / 2
            gmm_ms, gmm_host = cuda_ms(lambda: fit_gmm_1d(x, xv), iters=20)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fit_gmm_1d(x, xv)
                torch.cuda.synchronize()
            dev_us = sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            reassign_ms, _ = cuda_ms(lambda: head.reassign(*args), iters=10)
            targets_ms, _ = cuda_ms(
                lambda: head.reassigned(outs, batch, sizes), iters=5)
        return dict(gmm_rows=x.shape[0], gmm_slots=x.shape[1],
                    gmm_valid_rows=int((xv.sum(-1) >= 2).sum()),
                    candidates=int(r['cand'].sum()),
                    kept=int(r['keep'].sum()), gmm_event_ms=gmm_ms,
                    gmm_host_ms=gmm_host,
                    gmm_device_ms=dev_us / 3 / 1e3 if dev_us > 0
                    else 'not measured',
                    reassign_event_ms=reassign_ms,
                    reassigned_event_ms=targets_ms)
    return inspect


def paa_reassign_reference(torch, base, hw=(128, 192)):
    """PAA's reassigned positives of the CPU's outputs at 1x3x128x192 on
    the card and on the CPU: identical."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(1, *hw, seed=0, device='cpu')
    cpu = copy.deepcopy(base).eval()
    card = copy.deepcopy(base).to('cuda').eval()
    with torch.no_grad():
        outs = cpu(batch['image'])
        sizes = [tuple(c.shape[-2:]) for c in outs[0]]
        want = cpu.bbox_head.reassigned(outs, batch, sizes)
        got = card.bbox_head.reassigned(
            [[x.cuda() for x in part] for part in outs],
            {k: v.cuda() for k, v in batch.items()}, sizes)
    same = torch.equal(got['keep'].cpu(), want['keep']) and \
        torch.equal(got['cand'].cpu(), want['cand'])
    emit(dict(phase='paa_reassign_reference', config=PAA,
              input='1x3x{}x{}'.format(*hw),
              candidates=int(want['cand'].sum()),
              kept=int(want['keep'].sum()), identical=same))
    check(int(want['keep'].sum()) > 0 and same,
          'PAA reassigned positives: card vs CPU differ')
    del card
    torch.cuda.empty_cache()


def phase_paa_fsaf_freeanchor(torch, np, smi):
    """PAA, FSAF and FreeAnchor at full width, float32, seed 0 (the cls
    bias 0 so that the decode sees candidates): each R50 served at batch 1
    and 2 (PAA with score voting), trained at batch 2 with its peak memory
    (PAA's reassignment and GMM timed), held against the CPU (outputs, the
    first step's losses, the decode of the same outputs; PAA's reassigned
    positives). Returns the kernel's launch count over the main paths.
    Budget 25 s."""
    t_phase = time.perf_counter()
    launches = 0
    for config in (PAA, FSAF, FREE_ANCHOR):
        tag = {PAA: 'paa', FSAF: 'fsaf', FREE_ANCHOR: 'free_anchor'}[config]
        n, _ = family_serve(torch, smi, config, None, *PFF_CALLS,
                            phase=f'{tag}_serve')
        launches += n
        cfg, base = build_plain(torch, config)
        head = base.bbox_head
        with torch.no_grad():
            getattr(head, head.cls_pred_name).bias.zero_()
        model = base.to('cuda').eval()
        launches += serve_b2(torch, smi, model, config, f'{tag}_serve_b2',
                             *PFF_CALLS_B2)
        base = model.cpu()
        del model
        torch.cuda.empty_cache()
        n, _ = detector_steps(torch, smi, cfg, base, *PFF_STEPS, per_step=0,
                              phase=f'{tag}_train',
                              inspect=paa_gmm(torch) if config == PAA
                              else None)
        launches += n
        dense_reference(torch, np, cfg, base, config, f'{tag}_reference')
        if config == PAA:
            paa_reassign_reference(torch, base)
        del base
        torch.cuda.empty_cache()
    check(launches == PAA_FSAF_FREEANCHOR_LAUNCHES,
          f'paa_fsaf_freeanchor phase: {launches} nms_keep launches, '
          f'expected {PAA_FSAF_FREEANCHOR_LAUNCHES}')
    emit(dict(phase='paa_fsaf_freeanchor_done',
              seconds=time.perf_counter() - t_phase, budget_s=25,
              nms_keep_launches=launches))
    return launches


def bucket_decode_diff(torch, coder, props, bucket_cls, bucket_off, img_hw):
    """The bucketing decode of CPU predictions on the card against the CPU:
    (max box difference, max confidence difference)."""
    want = coder.decode(props, (bucket_cls, bucket_off), max_shape=img_hw)
    got = coder.decode(props.cuda(), (bucket_cls.cuda(), bucket_off.cuda()),
                       max_shape=img_hw.cuda())
    return tuple(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))


def sabl_retina_bucket_reference(torch, base, config, phase,
                                 hw=(128, 192)):
    """The bucket decode of every square of the CPU's outputs at
    1x3x128x192 on the card against the CPU: boxes and confidence within
    1e-4."""
    from ld_tpu_torch.models.heads.gfl_head import flatten_levels
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(1, *hw, seed=0, device='cpu')
    cpu = base.eval()
    with torch.no_grad():
        _, bcls, breg = cpu(batch['image'])
        sizes = [tuple(c.shape[-2:]) for c in bcls]
        squares = cpu.bbox_head.geometry(sizes, 'cpu')[0]
        box_diff, conf_diff = bucket_decode_diff(
            torch, cpu.bbox_head.coder, squares[None],
            flatten_levels(bcls), flatten_levels(breg), batch['img_hw'])
    emit(dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
              squares=squares.shape[0], box_max_abs_diff=box_diff,
              conf_max_abs_diff=conf_diff, tol=1e-4))
    check(box_diff <= 1e-4 and conf_diff <= 1e-4,
          f'{config} bucket decode: card vs CPU {box_diff}, {conf_diff}')


def det_multisets(got, want):
    """Two (dets, labels, valid) of the same inputs compared image by image
    as multisets of (score, label, box): a cascade's averaged softmax of
    peaked logits (`peak_scores`) gives two classes of one roi exactly
    equal scores, which the top-k may leave in either order. Returns
    (labels equal, the largest box or score difference)."""
    import numpy as np
    same, diff = True, 0.0
    for i in range(want[0].shape[0]):
        rows = []
        for dets, labels, valid in (got, want):
            d = dets[i][valid[i]].numpy()
            lab = labels[i][valid[i]].numpy()
            key = np.lexsort((d[:, 3].round(2), d[:, 2].round(2),
                              d[:, 1].round(2), d[:, 0].round(2), lab,
                              -d[:, 4].round(5)))
            rows.append((d[key], lab[key]))
        same = same and rows[0][1].shape == rows[1][1].shape and \
            bool((rows[0][1] == rows[1][1]).all())
        if same and len(rows[0][0]):
            diff = max(diff, float(np.abs(rows[0][0] - rows[1][0]).max()))
    return same, diff


def sabl_roi_decode_reference(torch, base, config, phase, hw=(128, 192),
                              proposals=200):
    """A SABL RoI head's `simple_test` of the CPU's features and top
    `proposals` proposals at 1x3x128x192 (fc_cls peaked, `peak_scores`) on the card against the
    CPU, one nms_keep launch: the same valid mask, the same (score, label,
    box) multisets (`det_multisets`), boxes within 1e-4; and its (last
    stage's) bucket decode of the CPU's predictions on
    those proposals, boxes and confidence within 1e-4."""
    import copy
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(1, *hw, seed=0, device='cpu')
    cpu = peak_scores(torch, copy.deepcopy(base)).eval()
    card = copy.deepcopy(cpu).to('cuda')
    roi = cpu.roi_head
    with torch.inference_mode():
        feats, rpn_outs = cpu(batch['image'])
        props, valid = (p[:, :proposals] for p in cpu.rpn_head.get_proposals(
            rpn_outs, batch['img_hw']))
        want = roi.simple_test(feats, props, valid, batch['img_hw'])
        before = nms_keep.launches
        got = card.roi_head.simple_test([f.cuda() for f in feats],
                                        props.cuda(), valid.cuda(),
                                        batch['img_hw'].cuda())
        torch.cuda.synchronize()
        launched = nms_keep.launches - before
        got = [x.cpu() for x in got]
        cascade = isinstance(roi.bbox_head, torch.nn.ModuleList)
        head = roi.bbox_head[-1] if cascade else roi.bbox_head
        coder = roi.coders[-1] if cascade else roi.coder
        _, (bc, bo) = head(roi._extract(feats, props, valid))
        r = props.shape[1]
        box_diff, conf_diff = bucket_decode_diff(
            torch, coder, props, bc.reshape(1, r, -1), bo.reshape(1, r, -1),
            batch['img_hw'])
    ok = want[2]
    same_labels, diff = det_multisets(got, want)
    emit(dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
              proposals=int(valid.sum()), detections=int(ok.sum()),
              decode_max_abs_diff=diff, decode_tol=1e-4,
              bucket_box_max_abs_diff=box_diff,
              bucket_conf_max_abs_diff=conf_diff, bucket_tol=1e-4,
              nms_keep_launches_reference=launched))
    check(launched == 1, f'{config} decode: {launched} launches')
    check(int(ok.sum()) > 0 and torch.equal(got[2], ok) and same_labels and
          diff <= 1e-4,
          f'{config} decode of the same inputs: card vs CPU, {diff}')
    check(box_diff <= 1e-4 and conf_diff <= 1e-4,
          f'{config} bucket decode: card vs CPU {box_diff}, {conf_diff}')
    del card
    torch.cuda.empty_cache()


def phase_sabl(torch, np, smi):
    """The SABL family at full width, float32, seed 0: SABL RetinaNet R50,
    plain and GN (the GN config's net is the plain one, caveat 57: the
    same state-dict keys), each served at batch 1 and 2 and trained at
    batch 2, held against the CPU (outputs, the first step's losses, the
    decode and the bucket decode of the same outputs); SABL Faster R-CNN
    and SABL Cascade R-CNN R50 (fc_cls peaked, `peak_scores`, for serving)
    served at batch 1 and 2, trained at batch 2 (the bucket losses of each
    stage), held against the CPU (the RPN's outputs, the losses, the RoI
    head's decode and bucket decode of the same inputs). Returns the
    kernel's launch count over the main paths. Budget 25 s."""
    import copy
    from ld_tpu_torch.apis import init_detector
    t_phase = time.perf_counter()
    launches = 0
    keys = {}
    for config in (SABL_RETINA, SABL_RETINA_GN):
        tag = 'sabl_retina_gn' if config == SABL_RETINA_GN else 'sabl_retina'
        n, _ = family_serve(torch, smi, config, None, *SABL_CALLS,
                            phase=f'{tag}_serve')
        launches += n
        cfg, base = build_plain(torch, config)
        keys[config] = sorted(base.state_dict())
        with torch.no_grad():
            base.bbox_head.retina_cls.bias.zero_()
        model = base.to('cuda').eval()
        launches += serve_b2(torch, smi, model, config, f'{tag}_serve_b2',
                             *SABL_CALLS_B2)
        base = model.cpu()
        del model
        torch.cuda.empty_cache()
        n, _ = detector_steps(torch, smi, cfg, base, *SABL_STEPS, per_step=0,
                              phase=f'{tag}_train')
        launches += n
        dense_reference(torch, np, cfg, base, config, f'{tag}_reference')
        sabl_retina_bucket_reference(torch, base, config,
                                     f'{tag}_bucket_reference')
        del base
        torch.cuda.empty_cache()
    check(keys[SABL_RETINA] == keys[SABL_RETINA_GN],
          'the SABL RetinaNet GN config does not build the plain net')
    for config in (SABL_FASTER, SABL_CASCADE):
        tag = 'sabl_cascade' if config == SABL_CASCADE else 'sabl_faster'
        model = peak_scores(torch, init_detector(float32_cfg(config),
                                                 device='cuda', seed=0))
        n, _, _ = roi_serve(torch, smi, model, config, f'{tag}_serve',
                            batches=(1, 2), warmup=SABL_ROI_CALLS[0],
                            timed=SABL_ROI_CALLS[1])
        launches += n
        del model
        torch.cuda.empty_cache()
        cfg, base = build_plain(torch, config)
        n, row = detector_steps(torch, smi, cfg, base, *SABL_ROI_STEPS,
                                per_step=1, phase=f'{tag}_train')
        launches += n
        stages = ('_s0', '_s1', '_s2') if config == SABL_CASCADE else ('', )
        check(all(f'loss_bbox_{k}{s}' in row['loss_last']
                  for k in ('cls', 'reg') for s in stages),
              f'{config}: bucket losses {sorted(row["loss_last"])}')
        roi_reference(torch, np, base, config, f'{tag}_reference')
        sabl_roi_decode_reference(torch, base, config, f'{tag}_decode')
        del base
        torch.cuda.empty_cache()
    check(launches == SABL_LAUNCHES, f'sabl phase: {launches} nms_keep '
          f'launches, expected {SABL_LAUNCHES}')
    emit(dict(phase='sabl_done', seconds=time.perf_counter() - t_phase,
              budget_s=25, nms_keep_launches=launches))
    return launches


def neck_serve(torch, smi, model, config, phase, hw, warmup, timed):
    """`forward_test` of `model` (on the card, in eval) at 1x3x`hw`:
    `warmup` + `timed` calls, 1 nms_keep launch a single-stage call and 2 a
    two-stage one, finite (1, 100, 5) detections with some valid, then the
    same call's detections bit-identical with the plain keep mask. Emits
    the row; returns the launch count."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    two_stage = hasattr(model, 'roi_head')
    per_call = 2 if two_stage else 1
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
            outs = model.forward_test(bench)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t) * 1e3)
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        dets, valid = outs[0], outs[2]
        check(launches == per_call * (warmup + timed),
              f'{config}: nms_keep launched {launches} times for '
              f'{warmup + timed} forward_test calls ({per_call} a call)')
        check(tuple(dets.shape) == (1, 100, 5) and
              bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0,
              f'{config}: forward_test output at {hw}')
        runs = []
        for keep in (nms_keep, nms_keep_ref):
            if two_stage:
                feats, rpn_outs = model(bench['image'])
                props = model.rpn_head.get_proposals(
                    rpn_outs, bench['img_hw'], keep_fn=keep)
                runs.append(model.roi_head.simple_test(
                    feats, *props, bench['img_hw'], keep_fn=keep))
            else:
                runs.append(model.bbox_head.get_bboxes(
                    model(bench['image']), bench['img_hw'], keep_fn=keep))
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f'{config}: detections with the kernel differ from the plain '
              'keep mask')
    row = dict(phase=phase, config=config, nvidia_smi=smi,
               detector=type(model).__name__,
               backbone=type(model.backbone).__name__,
               neck=type(model.neck).__name__,
               params=sum(p.numel() for p in model.parameters()),
               input=[1, 3, *hw], warmup_calls=warmup, timed_calls=timed,
               forward_test_ms=call_ms,
               forward_test_ms_mean=sum(call_ms) / len(call_ms),
               max_memory_allocated_bytes=peak, nms_keep_launches=launches,
               nms_keep_launches_per_call=per_call,
               detections=int(valid.sum()), plain_keep_identical=True)
    emit(row)
    return launches


def neck_models(torch, np, smi, models, phase_name, budget,
                own_sampler=False):
    """Each (config, size[, edit]) of `models` at full width, float32, seed
    0, the config changed by `edit(cfg)` where given (a dense head's cls
    bias 0, so that NMS sees candidates, and behind a BFP its cls weights x
    10): served at batch
    1 (`neck_serve`; a two-stage model's fc_cls peaked, `peak_scores`, and a
    hard-mining one's in its steps and reference too),
    stepped at its config's samples_per_gpu at the same size
    (with box-region gt masks where the RoI head has a mask head), the
    head's own loss in its first step (`HEAD_LOSS`), held
    against the CPU (`roi_reference` with `own_sampler` /
    `dense_reference`). Returns the launch count over the main paths."""
    import copy
    t_phase = time.perf_counter()
    launches = 0
    for config, hw, *edit in models:
        tag = os.path.splitext(os.path.basename(config))[0]
        if edit:
            tag = f'{tag}_{edit[0].__name__}'
        cfg, base = build_plain(torch, config, edit=edit[0] if edit
                                else None)
        two_stage = hasattr(base, 'roi_head')
        mining = two_stage and base.roi_head.hard_mining
        if mining:
            peak_scores(torch, base)
        if not two_stage:
            conv = getattr(base.bbox_head, base.bbox_head.cls_pred_name)
            with torch.no_grad():
                conv.bias.zero_()
                if type(base.neck).__name__ == 'SequentialNeck':
                    # BFP's averaged levels narrow the logits: at weights
                    # x 1 the 100 kept scores lie 1 ulp apart at 0.5, and
                    # the card's sigmoid orders them unlike the CPU's
                    conv.weight.mul_(10.0)
        model = copy.deepcopy(base)
        if two_stage and not mining:
            peak_scores(torch, model)
        model = model.to('cuda').eval()
        launches += neck_serve(torch, smi, model, config, f'{tag}_serve', hw,
                               *DN_CALLS)
        del model
        torch.cuda.empty_cache()
        masks = two_stage and base.roi_head.mask_head is not None
        batch_size = cfg.data.samples_per_gpu
        n, row = detector_steps(
            torch, smi, cfg, base, *DN_STEPS, per_step=int(two_stage),
            phase=f'{tag}_train', batch_size=batch_size, pad=hw,
            batch=masked_batch(torch, np, batch_size, hw) if masks
            else None)
        launches += n
        key = HEAD_LOSS.get(type(base.roi_head if two_stage
                                 else base.bbox_head).__name__)
        check(key is None or row['loss_first'].get(key, 0) > 0,
              f'{config}: no {key} in {sorted(row["loss_first"])}')
        if two_stage:
            # an HTC's mask towers run on every sampled roi of three
            # stages: the CPU's top 20 proposals
            roi_reference(torch, np, base, config, f'{tag}_reference',
                          own_sampler=own_sampler,
                          proposals=20 if 'htc' in config else 50)
        else:
            dense_reference(torch, np, cfg, base, config,
                            f'{tag}_reference',
                            hw=(128, 256) if 'nasfpn' in config
                            else (128, 192))
        del base
        torch.cuda.empty_cache()
    emit(dict(phase=f'{phase_name}_done',
              seconds=time.perf_counter() - t_phase, budget_s=budget,
              nms_keep_launches=launches))
    return launches


def phase_detectors_necks(torch, np, smi):
    """DetectoRS (SAC + RFP, RFP alone) and the remaining necks (FPG,
    NAS-FPN, NAS-FCOS, CARAFE, PAFPN) at full width (`neck_models`).
    Budget 45 s."""
    launches = neck_models(torch, np, smi, DN_MODELS, 'detectors_necks', 45)
    check(launches == DN_LAUNCHES, f'detectors_necks phase: {launches} '
          f'nms_keep launches, expected {DN_LAUNCHES}')
    return launches


def phase_libra_pisa(torch, np, smi):
    """Libra R-CNN (FPN + BFP, CombinedSampler; BalancedL1 on the
    RetinaNet) and PISA (Faster and Mask R-CNN, RetinaNet) R50 at full width
    (`neck_models`, each RoI sampler its config's type in the reference;
    `loss_carl` in each PISA model's first step), then PISA SSD300 served at
    batch 1, stepped at batch 8 and held against the CPU. Budget 40 s."""
    t_phase = time.perf_counter()
    launches = neck_models(torch, np, smi, LP_MODELS, 'libra_pisa_models',
                           30, own_sampler=True)
    cfg, base = build_plain(torch, PISA_SSD)
    launches += ssd_serve(torch, smi, PISA_SSD, base, {1: PISA_SSD_CALLS},
                          'pisa_ssd300_serve')
    size = base.backbone.input_size
    n, row = detector_steps(torch, smi, cfg, base, *PISA_SSD_STEPS,
                            per_step=0, phase='pisa_ssd300_train',
                            batch_size=8, pad=(size, size))
    launches += n
    check(row['loss_first'].get('loss_carl', 0) > 0,
          f'{PISA_SSD}: no loss_carl in {sorted(row["loss_first"])}')
    dense_reference(torch, np, cfg, base, PISA_SSD, 'pisa_ssd300_reference',
                    hw=(size, size))
    del base
    torch.cuda.empty_cache()
    check(launches == LP_LAUNCHES, f'libra_pisa phase: {launches} nms_keep '
          f'launches, expected {LP_LAUNCHES}')
    emit(dict(phase='libra_pisa_done', seconds=time.perf_counter() -
              t_phase, budget_s=40, nms_keep_launches=launches))
    return launches


def sampler_check(torch, smi, batch_size=2, hw=(800, 1344)):
    """Each sampler of `CHECK_SAMPLERS` on the card and on the CPU, on the
    same inputs: uniform draws made on the CPU and copied to the card, and
    the candidates of the ScoreHLR Faster R-CNN's own step on the card (the
    gts joined to its training proposals, their assignment's `gt_inds`, the
    largest IoU with a gt, the boxes, and the preliminary pass's CE and
    fg scores, `hard_mining_extras`, its fc_cls peaked) copied to the CPU.
    The selections must be identical and ScoreHLR's label weights within
    1e-6. No nms_keep launch counts here (the proposals' are not a main
    path)."""
    from ld_tpu_torch.ops.boxes import bbox_overlaps
    from ld_tpu_torch.ops.samplers import build_sampler
    from ld_tpu_torch.testing import detection_batch
    t = time.perf_counter()
    cfg, base = build_plain(torch, FASTER_CONFIG, edit=score_hlr_sampler)
    model = peak_scores(torch, base).to('cuda').train()
    batch = detection_batch(batch_size, *hw, num_classes=80, seed=0,
                            device='cuda')
    roi = model.roi_head
    with torch.no_grad():
        feats, rpn_outs = model(batch['image'])
        props, valid = model._proposals(rpn_outs, batch['img_hw'],
                                        model.train_cfg.get('rpn_proposal'))
        extras = roi.hard_mining_extras(feats, props, valid, batch)
        gtb, gtl, gtv = (batch['gt_bboxes'], batch['gt_labels'].long(),
                         batch['gt_valid'])
        cand = torch.cat([gtb, props], dim=1)
        cv = torch.cat([gtv, valid], dim=1)
        res = roi.assigner.assign(cand, None, gtb, gtl, gtv, cv,
                                  num_classes=roi.num_classes)
        max_iou = torch.where(gtv[:, None, :], bbox_overlaps(cand, gtb),
                              torch.zeros((), device='cuda')).amax(-1)
    card = dict(pos=res.pos_mask & cv, neg=~res.pos_mask & cv,
                gt_inds=res.assigned_gt_inds, max_overlaps=max_iou,
                boxes=cand, **extras)
    cpu = {k: v.cpu() for k, v in card.items()}
    draws = torch.rand((3, *cand.shape[:2]),
                       generator=torch.Generator().manual_seed(0))
    rows = {}
    for name, s_cfg in CHECK_SAMPLERS.items():
        sampler = build_sampler(dict(s_cfg))
        n = 2 + sampler.extra_neg_draws
        outs = []
        for ins, d in ((card, draws[:n].to('cuda')), (cpu, draws[:n])):
            kw = {k: v for k, v in ins.items() if k not in ('pos', 'neg')}
            with torch.no_grad():
                outs.append([None if x is None else x.cpu()
                             for x in sampler.select(d, ins['pos'],
                                                     ins['neg'], **kw)])
        (g_pos, g_neg, g_w), (c_pos, c_neg, c_w) = outs
        same = torch.equal(g_pos, c_pos) and torch.equal(g_neg, c_neg)
        row = dict(identical=same, picked_pos=g_pos.sum(-1).tolist(),
                   picked_neg=g_neg.sum(-1).tolist())
        if g_w is not None:
            neg_w = c_w[cpu['neg']]
            row.update(weight_max_abs_diff=float((g_w - c_w).abs().max()),
                       weight_min=float(neg_w.min()),
                       weight_max=float(neg_w.max()),
                       valid_negatives=int((cpu['neg'] & (
                           cpu['scores'] > s_cfg['score_thr'])).sum()))
        rows[name] = row
    emit(dict(phase='sampler_check', config=FASTER_CONFIG, nvidia_smi=smi,
              batch=[batch_size, 3, *hw],
              candidates=list(cand.shape[:2]),
              positives=card['pos'].sum(-1).tolist(),
              negatives=card['neg'].sum(-1).tolist(), samplers=rows,
              weight_tol=1e-6, seconds=time.perf_counter() - t))
    for name, row in rows.items():
        check(row['identical'], f'sampler {name}: the card and the CPU '
              'select differently')
        check(row.get('weight_max_abs_diff', 0) <= 1e-6,
              f'sampler {name}: label weights differ by '
              f'{row.get("weight_max_abs_diff")}')
    w = rows['score_hlr']
    check(w['valid_negatives'] > 0 and w['weight_min'] < w['weight_max'],
          f'ScoreHLR: no decayed label weight ({w})')
    del model, feats, rpn_outs
    torch.cuda.empty_cache()


def phase_groie_mining(torch, np, smi):
    """GRoIE Faster, Mask and Grid R-CNN R50 and Faster R-CNN R50 with OHEM
    and with ScoreHLR at full width (`neck_models`, each RoI sampler its
    config's type in the reference), then `sampler_check`. Budget 30 s."""
    t_phase = time.perf_counter()
    launches = neck_models(torch, np, smi, GM_MODELS, 'groie_mining_models',
                           25, own_sampler=True)
    sampler_check(torch, smi)
    check(launches == GM_LAUNCHES, f'groie_mining phase: {launches} '
          f'nms_keep launches, expected {GM_LAUNCHES}')
    emit(dict(phase='groie_mining_done', seconds=time.perf_counter() -
              t_phase, budget_s=30, nms_keep_launches=launches))
    return launches


def phase_grid_point_rend(torch, np, smi):
    """Grid R-CNN and PointRend R50 at full width (`neck_models`; the grid
    loss and the point loss in each first step). Budget 15 s."""
    launches = neck_models(torch, np, smi, GP_MODELS, 'grid_point_rend', 15)
    check(launches == GP_LAUNCHES, f'grid_point_rend phase: {launches} '
          f'nms_keep launches, expected {GP_LAUNCHES}')
    return launches


def deform_roi_pool_bound(torch, model, bench):
    """The least time one call's deformable RoI pooling could take on the
    card: its two passes' bilinear reads (4 corners of C float32 values a
    sample, 2 x 2 samples a bin, every valid roi) and its output written,
    over the HBM rate, against its FCs' float32 operations (2 x the
    multiply-adds of each Linear over the rois) over the fp32 peak; the
    larger of the two, with what bounds it."""
    ext = model.roi_head.bbox_roi_extractor
    seen = []
    hook = ext.register_forward_hook(
        lambda m, args, out: seen.append((int(args[2].sum()),
                                          int(args[0][0].shape[1]))))
    try:
        with torch.inference_mode():
            model.forward_test(bench)
    finally:
        hook.remove()
    rois, c = seen[-1]
    bins = ext.out_size * ext.out_size
    samples = rois * bins * 4
    gather_bytes = 2 * samples * 4 * c * 4 + rois * bins * c * 4
    fcs = [m for fc in (ext.offset_fc, ext.mask_fc) if fc is not None
           for m in fc if hasattr(m, 'in_features')]
    flops = sum(2 * rois * m.in_features * m.out_features for m in fcs)
    by_bytes = gather_bytes / PEAK_HBM_BYTES * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(deform_roi_pool_rois=rois,
                deform_roi_pool_gather_bytes=gather_bytes,
                deform_roi_pool_fc_flops=flops,
                deform_roi_pool_bound_ms=max(by_bytes, by_ops),
                deform_roi_pool_bound_by='bytes' if by_bytes >= by_ops
                else 'operations')


def rpn_candidates(torch, model, cfg_rpn, batch_size=2, hw=(800, 1344)):
    """The (boxes, valid, thr) a two-stage `model`'s RPN hands nms_keep
    on a seeded batch at `hw` under `cfg_rpn` (its test or its
    training-proposal config); a TridentNet's over its 3B images."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep
    captured = []

    def capture(boxes, valid, thr):
        captured.append((boxes.clone(), valid.clone(), thr))
        return nms_keep(boxes, valid, thr)
    image = torch.randn(batch_size, 3, *hw, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(1))
    with torch.inference_mode():
        _, rpn_outs = model(image)
        # a TridentNet's RPN sees its 3B branch-folded images
        img_hw = torch.tensor([hw] * rpn_outs[0][0].shape[0],
                              dtype=torch.float32, device='cuda')
        model.rpn_head.get_proposals(rpn_outs, img_hw, cfg=cfg_rpn,
                                     keep_fn=capture)
    return captured[0]


def dynamic_reference(torch, base, config, phase, proposals=100,
                      hw=(128, 192)):
    """Dynamic R-CNN's per-image IoU thresholds and its SmoothL1 beta on
    the card against the CPU at 1x3x`hw`: the CPU's top `proposals`
    training proposals on both, the same uniform draws (made on the CPU),
    the sampled rois identical; thresholds and beta within 1e-6."""
    import copy
    from ld_tpu_torch.testing import detection_batch
    cpu_batch = detection_batch(1, *hw, seed=0, device='cpu')
    props, draws, runs = None, None, {}
    for device in ('cpu', 'cuda'):
        model = copy.deepcopy(base).to(device).train()
        b = {k: v.to(device) for k, v in cpu_batch.items()}
        head = model.roi_head
        with torch.no_grad():
            feats, rpn_outs = model(b['image'])
            if props is None:
                props = [p[:, :proposals].cpu() for p in model._proposals(
                    rpn_outs, b['img_hw'], model.train_cfg.get(
                        'rpn_proposal'))]
                n = props[0].shape[1] + b['gt_bboxes'].shape[1]
                draws = torch.rand((3, 1, n),
                                   generator=torch.Generator().manual_seed(0))
            p, v = (x.to(device) for x in props)
            thr = head.iou_thresholds(p, v, b['gt_bboxes'],
                                      b['gt_valid'])[0]
            s = head.sample_rois(p, v, b['gt_bboxes'], b['gt_labels'].long(),
                                 b['gt_valid'], None, draws=draws.to(device))
            posf = s['roi_pos'].reshape(-1, 1).float().expand(-1, 4)
            beta = head.loss_bbox.beta(s['targets'].reshape(-1, 4), posf)
        runs[device] = (thr.cpu(), float(beta), s['roi_pos'].cpu(),
                        s['rois'].cpu())
        del model, feats, rpn_outs
    (c_thr, c_beta, c_pos, c_rois), (g_thr, g_beta, g_pos, g_rois) = \
        runs['cpu'], runs['cuda']
    row = dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
               iou_thr_cpu=c_thr.tolist(), iou_thr_card=g_thr.tolist(),
               beta_cpu=c_beta, beta_card=g_beta,
               positives=int(c_pos.sum()),
               iou_thr_max_abs_diff=float((g_thr - c_thr).abs().max()),
               beta_abs_diff=abs(g_beta - c_beta), tol=1e-6)
    emit(row)
    check(torch.equal(g_pos, c_pos) and
          float((g_rois - c_rois).abs().max()) <= 1e-4,
          f'{config}: the dynamic sampler picks differently on the card')
    check(row['iou_thr_max_abs_diff'] <= 1e-6 and
          row['beta_abs_diff'] <= 1e-6 * max(c_beta, 1.0),
          f'{config}: dynamic IoU threshold / beta, card vs CPU {row}')
    torch.cuda.empty_cache()


def phase_roi_variants(torch, np, smi):
    """SCNet, Faster and Mask R-CNN C4, deformable / modulated deformable
    RoI pooling Faster R-CNN, Double-Head and Dynamic R-CNN R50 at full
    width, float32, seed 0 (`VAR_MODELS`): each served at batch 1 and 2
    (`roi_serve`, fc_cls peaked: 2 launches a call, outputs identical with
    the plain keep mask, the C4 mask model's 14x14 masks), with dpool /
    mdpool the deformable RoI pooling's share of a call's device time and
    its bound; stepped at batch 2 (box-region gt masks where a mask head
    trains; SCNet's first step with `loss_glbctx`); the card against the
    CPU at 1x3x128x192 (`roi_reference`: every loss term; the C4 masks),
    Dynamic R-CNN's thresholds and beta too (`dynamic_reference`); then
    nms_keep alone on the C4 RPN's test (K = 6000) and training
    (K = 12000) candidates at B = 1 and 2. Budget 45 s. Returns the
    launches over the main paths and the C4 kernel rows by (K, B)."""
    import copy
    from ld_tpu_torch.models.heads.roi_head import DeformRoIPoolExtractor
    t_phase = time.perf_counter()
    launches, c4_rows = 0, {}
    for config, masks in VAR_MODELS:
        tag = os.path.splitext(os.path.basename(config))[0]
        cfg, base = build_plain(torch, config)
        model = peak_scores(torch, copy.deepcopy(base)).to('cuda').eval()
        c4 = base.roi_head.shared_head is not None
        n, row, captured = roi_serve(
            torch, smi, model, config, f'{tag}_serve', batches=(1, 2),
            warmup=VAR_CALLS[0], timed=VAR_CALLS[1],
            mask_size=14 if c4 else 28)
        launches += n
        if isinstance(model.roi_head.bbox_roi_extractor,
                      DeformRoIPoolExtractor):
            bench = dict(image=torch.randn(
                1, 3, 800, 1344, device='cuda',
                generator=torch.Generator('cuda').manual_seed(0)),
                img_hw=torch.tensor([[800.0, 1344.0]], device='cuda'))
            emit(dict(phase=f'{tag}_deform_roi_pool', config=config,
                      nvidia_smi=smi,
                      **module_share(torch, model, bench,
                                     DeformRoIPoolExtractor,
                                     'deform_roi_pool'),
                      **deform_roi_pool_bound(torch, model, bench)))
        if c4 and not c4_rows:
            test = captured[0]
            train = rpn_candidates(torch, model,
                                   model.train_cfg.get('rpn_proposal'))
            check(tuple(test[0].shape) == (2, C4_RPN_K[0], 4) and
                  tuple(train[0].shape) == (2, C4_RPN_K[1], 4),
                  f'{config}: the RPN NMS at K = {test[0].shape[1]} (test),'
                  f' {train[0].shape[1]} (training)')
            rows = kernel_rows(torch, smi, [
                (boxes[:b].contiguous(), valid[:b].contiguous(), thr)
                for boxes, valid, thr in (test, train) for b in (1, 2)],
                ('c4_rpn_test', ) * 2 + ('c4_rpn_train', ) * 2)
            c4_rows = {(r['K'], r['B']): r for r in rows}
        del model, captured
        torch.cuda.empty_cache()
        n, row = detector_steps(
            torch, smi, cfg, base, *VAR_STEPS, per_step=1,
            phase=f'{tag}_train',
            batch=masked_batch(torch, np) if masks else None)
        launches += n
        key = HEAD_LOSS.get(type(base.roi_head).__name__)
        check(key is None or row['loss_first'].get(key, 0) > 0,
              f'{config}: no {key} in {sorted(row["loss_first"])}')
        check(not masks or any(k.startswith('loss_mask')
                               for k in row['loss_first']),
              f'{config}: no mask loss in {sorted(row["loss_first"])}')
        # SCNet's six mask-tower runs on every sampled roi (HTC's
        # information flow) are the phase's largest CPU cost: its top 20
        roi_reference(torch, np, base, config, f'{tag}_reference',
                      proposals=20 if 'scnet' in config else 50)
        if type(base.roi_head).__name__ == 'DynamicRoIHead':
            dynamic_reference(torch, base, config, f'{tag}_dynamic')
        del base
        torch.cuda.empty_cache()
    check(launches == VAR_LAUNCHES, f'roi_variants phase: {launches} '
          f'nms_keep launches, expected {VAR_LAUNCHES}')
    emit(dict(phase='roi_variants_done', seconds=time.perf_counter() -
              t_phase, budget_s=45, nms_keep_launches=launches))
    return launches, c4_rows


def phase_legacy_ghm(torch, np, smi):
    """RetinaNet R50 with the GHM losses (`GHM_RETINA`): 1 + 1 steps at
    batch 2 (GHMC / GHMR finite), its outputs, first-step losses and decode
    at 1x3x128x192 against the CPU (`dense_reference`); Faster R-CNN and
    RetinaNet R50 v1 (`V1_FASTER`, `V1_RETINA`) served at batch 1
    (`neck_serve`: 2 / 1 launches a call, identical with the plain keep
    mask), their anchors on the card bit-equal to the CPU's (the RPN's the
    plain layout at centre offset 0.5, the RetinaNet's mmdet v1's), and the
    decode of the CPU's outputs (the RPN's proposals, the RetinaNet's
    detections) against the CPU. Budget 15 s. Returns the launches over
    the main paths."""
    import copy
    from ld_tpu_torch.ops.anchors import AnchorGenerator, LegacyAnchorGenerator
    t_phase = time.perf_counter()
    cfg, base = build_plain(torch, GHM_RETINA)
    check((type(base.bbox_head.loss_cls).__name__,
           type(base.bbox_head.loss_bbox).__name__) == ('GHMC', 'GHMR'),
          f'{GHM_RETINA}: losses')
    launches, row = detector_steps(torch, smi, cfg, base, *LG_STEPS,
                                   per_step=0, phase='retinanet_ghm_train')
    check(all(row['loss_first'].get(k, 0) > 0
              for k in ('loss_cls', 'loss_bbox')),
          f'{GHM_RETINA}: losses {row["loss_first"]}')
    conv = base.bbox_head.retina_cls
    with torch.no_grad():
        conv.bias.zero_()
    dense_reference(torch, np, cfg, base, GHM_RETINA,
                    'retinanet_ghm_reference')
    del base
    for config, kind in ((V1_FASTER, AnchorGenerator),
                         (V1_RETINA, LegacyAnchorGenerator)):
        tag = os.path.splitext(os.path.basename(config))[0]
        _, base = build_plain(torch, config)
        two_stage = hasattr(base, 'roi_head')
        head = base.rpn_head if two_stage else base.bbox_head
        gen = head.anchor_generator
        if two_stage:
            peak_scores(torch, base)
        else:
            with torch.no_grad():
                base.bbox_head.retina_cls.bias.zero_()
        sizes = [(-(-800 // s[1]), -(-1344 // s[0])) for s in gen.strides]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            gen.grid_anchors(sizes, device='cuda'), gen.grid_anchors(sizes)))
        check(type(gen) is kind and same and
              (not two_stage or gen.center_offset == 0.5),
              f'{config}: {type(gen).__name__} anchors, card vs CPU equal '
              f'{same}')
        emit(dict(phase=f'{tag}_anchors', config=config,
                  generator=type(gen).__name__,
                  center_offset=getattr(gen, 'center_offset', None),
                  anchors=sum(a.shape[0] for a in gen.grid_anchors(sizes)),
                  card_equals_cpu=same))
        model = copy.deepcopy(base).to('cuda').eval()
        launches += neck_serve(torch, smi, model, config, f'{tag}_serve',
                               (800, 1344), *LG_CALLS)
        del model
        decode_reference(torch, base, f'{tag}_decode_reference', config)
        del base
        torch.cuda.empty_cache()
    check(launches == LG_LAUNCHES, f'legacy_ghm phase: {launches} nms_keep '
          f'launches, expected {LG_LAUNCHES}')
    emit(dict(phase='legacy_ghm_done', seconds=time.perf_counter() -
              t_phase, budget_s=15, nms_keep_launches=launches))
    return launches


def serve_batches(torch, smi, model, config, phase, hw=(800, 1344),
                  batches=(1, 2), warmup=1, timed=2):
    """`forward_test` of a single-stage or RPN detector on the card on
    seeded batches at `hw`: `warmup` + `timed` calls at each batch size,
    1 launch a call, finite (B, max_per_img, 5) outputs (detections, or an
    RPN's proposals) with some valid an image; at the largest batch the
    decode bit-identical with the plain keep mask. Emits the row; returns
    the launch count."""
    from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
    rpn = not hasattr(model, 'bbox_head')
    gen = torch.Generator('cuda').manual_seed(0)
    benches = {b: dict(image=torch.randn(b, 3, *hw, device='cuda',
                                         generator=gen),
                       img_hw=torch.tensor([[float(x) for x in hw]] * b,
                                           device='cuda'))
               for b in batches}
    k = model.test_cfg['rpn']['max_per_img'] if rpn else 100
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_ms = {}
    with torch.inference_mode():
        # ---- the main path: counts from 0, read right after --------------
        nms_keep.launches = 0
        for b, bench in benches.items():
            for _ in range(warmup):
                model.forward_test(bench)
            torch.cuda.synchronize()
            times = []
            for _ in range(timed):
                t = time.perf_counter()
                dets, _, valid = model.forward_test(bench)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            call_ms[b] = times
            check(tuple(dets.shape) == (b, k, 5) and
                  bool(torch.isfinite(dets).all()) and
                  bool(valid.any(1).all()),
                  f'{config} forward_test at batch {b}, {hw}')
        launches = nms_keep.launches
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        calls = len(batches) * (warmup + timed)
        check(launches == calls, f'{config}: {launches} launches for '
              f'{calls} calls')
        bench = benches[max(batches)]
        if rpn:
            outs = model(bench['image'])[1]
            got, want = (model.rpn_head.get_proposals(
                outs, bench['img_hw'], model.test_cfg['rpn'], keep_fn=keep)
                for keep in (nms_keep, nms_keep_ref))
        else:
            outs = model(bench['image'])
            got, want = (model.bbox_head.get_bboxes(outs, bench['img_hw'],
                                                    keep_fn=keep)
                         for keep in (nms_keep, nms_keep_ref))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f'{config}: the decode with the kernel differs from the '
              'plain keep mask')
    row = dict(phase=phase, config=config, nvidia_smi=smi, input=list(hw),
               detector=type(model).__name__, max_memory_allocated_bytes=peak,
               nms_keep_launches=launches, valid=int(got[-1].sum()),
               plain_keep_identical=True)
    for b, times in call_ms.items():
        row[f'forward_test_ms_b{b}'] = times
        row[f'forward_test_ms_b{b}_mean'] = sum(times) / len(times)
    emit(row)
    return launches


def assigner_reference(torch, base, config, phase, hw=(128, 192)):
    """The assigners on the CPU's outputs at 1x3x`hw`, on the card against
    the CPU: a Cascade RPN's `RegionAssigner` (its anchors) and stage-2
    `MaxIoUAssigner` (the refined anchors), TOOD's `TaskAlignedAssigner`
    (its probabilities and decoded boxes); every field equal but the
    overlaps and TOOD's alignment metric, within 1e-6 of their largest."""
    import copy
    from ld_tpu_torch.models.heads.gfl_head import flatten_levels
    from ld_tpu_torch.testing import detection_batch
    batch = detection_batch(1, *hw, seed=0, device='cpu')
    cpu = copy.deepcopy(base).eval()
    with torch.inference_mode():
        outs = cpu(batch['image'])
    crpn = hasattr(cpu, 'rpn_head')
    runs = {}
    for device in ('cpu', 'cuda'):
        b = {k: v.to(device) for k, v in batch.items()}
        gts = (b['gt_bboxes'], b['gt_labels'], b['gt_valid'])
        with torch.inference_mode():
            if crpn:
                head = cpu.rpn_head
                parts = [[x.to(device) for x in part] for part in outs[1]]
                sizes = [tuple(x.shape[-2:]) for x in parts[0]]
                mlvl = head.anchor_generator.grid_anchors(sizes, device)
                num = [a.shape[0] for a in mlvl]
                res = [head.region_assigner.assign(
                    torch.cat(mlvl), num, *gts, num_classes=1,
                    anchor_scale=head.anchor_scale, strides=head.strides),
                    head.iou_assigner.assign(flatten_levels(parts[1], 4),
                                             num, *gts, num_classes=1)]
                extra = None
            else:
                head = cpu.bbox_head
                cls, box = ([x.to(device) for x in part] for part in outs)
                sizes = [tuple(x.shape[-2:]) for x in cls]
                anchors, _, strides, _ = head.level_geometry(sizes, device)
                valid = torch.stack([torch.cat(
                    head.anchor_generator.valid_flags(sizes, s, device))
                    for s in b['img_hw']])
                r, extra = head.assigner.assign(
                    flatten_levels(cls),
                    flatten_levels(box) * strides[None, :, None], anchors,
                    *gts, valid, num_classes=head.num_classes)
                res = [r]
        runs[device] = ([[x.cpu() for x in r] for r in res],
                        None if extra is None else extra.cpu())
    (c_res, c_extra), (g_res, g_extra) = runs['cpu'], runs['cuda']
    positives = [int(r[3].sum()) for r in c_res]
    overlap_diff = max(float((g[1] - c[1]).abs().max())
                       for c, g in zip(c_res, g_res))
    same = all(torch.equal(c[i], g[i]) for c, g in zip(c_res, g_res)
               for i in (0, 2, 3))
    row = dict(phase=phase, config=config, input='1x3x{}x{}'.format(*hw),
               assigners=['RegionAssigner', 'MaxIoUAssigner'] if crpn
               else ['TaskAlignedAssigner'], positives=positives,
               fields_equal=same, overlaps_max_abs_diff=overlap_diff,
               tol=1e-6)
    if c_extra is not None:
        row['metric_max_diff_of_largest'] = float(
            (g_extra - c_extra).abs().max() / c_extra.abs().max())
    emit(row)
    check(all(positives) and same and overlap_diff <= 1e-6 and
          row.get('metric_max_diff_of_largest', 0.0) <= 1e-6,
          f'{config}: assignment, card vs CPU {row}')


def phase_crpn_tood(torch, np, smi):
    """The Cascade RPN Faster R-CNN (`roi_serve`, fc_cls peaked: 2 launches
    a call; the adaptive convs' share of a call's device time and their
    gather bound, `deform_conv_share`), the Cascade RPN alone and TOOD R50
    (`serve_batches`: 1 launch a call; TOOD's cls biases at 0 and its
    offset branch seeded, so that NMS sees candidates and the boxes move) at
    800x1344, float32, seed 0: each served at batch 1 and 2 and stepped at
    batch 2 (the Faster R-CNN 1 launch a step), then held against the CPU
    at 1x3x128x192 (`roi_reference` / `dense_reference`: outputs, every
    loss term, the decode; `assigner_reference`: RegionAssigner,
    MaxIoUAssigner, TaskAlignedAssigner). Budget 20 s. Returns the
    launches over the main paths."""
    import copy
    t_phase = time.perf_counter()
    launches = 0
    for config in (CRPN_FASTER, CRPN_RPN, TOOD_CONFIG):
        tag = os.path.splitext(os.path.basename(config))[0]
        cfg, base = build_plain(torch, config)
        faster = hasattr(base, 'roi_head')
        if config == TOOD_CONFIG:
            head = base.bbox_head
            with torch.no_grad():
                head.tood_cls.bias.zero_()
                head.cls_prob_module[2].bias.zero_()
                head.reg_offset_module[2].weight.normal_(
                    0.0, 0.01, generator=torch.Generator().manual_seed(3))
        model = copy.deepcopy(base)
        if faster:
            peak_scores(torch, model)
        model = model.to('cuda').eval()
        if faster:
            n, _, _ = roi_serve(torch, smi, model, config, f'{tag}_serve',
                                warmup=CT_CALLS[0], timed=CT_CALLS[1])
            bench = dict(image=torch.randn(
                1, 3, 800, 1344, device='cuda',
                generator=torch.Generator('cuda').manual_seed(0)),
                img_hw=torch.tensor([[800.0, 1344.0]], device='cuda'))
            emit(dict(phase=f'{tag}_adaptive_conv', config=config,
                      nvidia_smi=smi, **deform_conv_share(
                          torch, model, bench, name='crpn_adaptive_conv')))
        else:
            n = serve_batches(torch, smi, model, config, f'{tag}_serve',
                              warmup=CT_CALLS[0], timed=CT_CALLS[1])
        launches += n
        del model
        torch.cuda.empty_cache()
        n, row = detector_steps(torch, smi, cfg, base, *CT_STEPS,
                                per_step=int(faster), phase=f'{tag}_train')
        launches += n
        if faster:
            roi_reference(torch, np, base, config, f'{tag}_reference')
        else:
            dense_reference(torch, np, cfg, base, config, f'{tag}_reference')
        if config != CRPN_FASTER:
            assigner_reference(torch, base, config, f'{tag}_assigners')
        del base
        torch.cuda.empty_cache()
    check(launches == CT_LAUNCHES, f'crpn_tood phase: {launches} nms_keep '
          f'launches, expected {CT_LAUNCHES}')
    emit(dict(phase='crpn_tood_done', seconds=time.perf_counter() - t_phase,
              budget_s=20, nms_keep_launches=launches))
    return launches


def trident_branch_reference(torch, np, base, hw=(128, 192)):
    """TridentNet's three branches (the backbone's 3B output) at 1x3x`hw`
    on the card against the CPU, each within 5e-5 of its largest value."""
    import copy
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, *hw)
                         .astype(np.float32))
    with torch.inference_mode():
        c = copy.deepcopy(base.backbone).eval()(x)[0]
        g = copy.deepcopy(base.backbone).to('cuda').eval()(x.cuda())[0]
        g = g.cpu()
    diffs = [float((g[i] - c[i]).abs().max() / c[i].abs().max())
             for i in range(c.shape[0])]
    spread = [float((c[i] - c[0]).abs().max()) for i in range(1, 3)]
    emit(dict(phase='tridentnet_branch_reference', input='1x3x{}x{}'.format(
        *hw), branches=c.shape[0], branch_max_diff_of_largest=diffs,
        tol_of_largest=5e-5, branch_spread_cpu=spread))
    check(c.shape[0] == 3 and max(diffs) <= 5e-5 and min(spread) > 0,
          f'TridentNet branches, card vs CPU {diffs}, spread {spread}')


def phase_yolo_trident(torch, np, smi):
    """YOLOv3 D53 (float32, seed 0; the three configs' one model) served at
    320, 416 and 608 at batch 1 and 2 on seeded batches at those sizes
    (`serve_batches`: 1 launch a call), stepped at batch 2 at 608 (no
    launch), held against the CPU at 1x3x128x192 (`dense_reference`:
    outputs, every loss term, the decode); TridentNet R50-caffe at
    800x1344 (`roi_serve`, fc_cls peaked: 2 launches a call), stepped at
    batch `TRIDENT_STEP_BATCH` (1 launch a step, on the 3B branch-folded
    images), held against the CPU at 1x3x128x192 (`roi_reference` on its
    branch-tiled gts, each branch's map, `trident_branch_reference`); then
    nms_keep alone on its training RPN's K = 12000 candidates at B = 1, 3
    and 6. Budget 30 s. Returns the launches over the main paths and the
    kernel rows by (K, B)."""
    import copy
    from ld_tpu_torch import Config
    t_phase = time.perf_counter()
    launches = 0
    models = {size: Config.fromfile(os.path.join(ROOT, c)).model
              for size, c in YOLO_CONFIGS}
    check(all(m == models[608] for m in models.values()),
          'the YOLOv3 configs build different models')
    cfg, base = build_plain(torch, YOLO_CONFIGS[-1][1])
    model = copy.deepcopy(base).to('cuda').eval()
    for size, config in YOLO_CONFIGS:
        launches += serve_batches(torch, smi, model, config,
                                  f'yolov3_{size}_serve', (size, size),
                                  warmup=YT_CALLS[0], timed=YT_CALLS[1])
    del model
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *YT_STEPS, per_step=0,
                          phase='yolov3_608_train', pad=(608, 608))
    launches += n
    dense_reference(torch, np, cfg, base, YOLO_CONFIGS[-1][1],
                    'yolov3_reference')
    del base
    cfg, base = build_plain(torch, TRIDENT_CONFIG)
    model = peak_scores(torch, copy.deepcopy(base)).to('cuda').eval()
    n, _, _ = roi_serve(torch, smi, model, TRIDENT_CONFIG, 'tridentnet_serve',
                        warmup=YT_CALLS[0], timed=YT_CALLS[1])
    launches += n
    train = rpn_candidates(torch, model, model.train_cfg.get('rpn_proposal'))
    check(tuple(train[0].shape) == (6, 12000, 4),
          f'TridentNet training RPN NMS at {tuple(train[0].shape)}')
    rows = kernel_rows(torch, smi, [
        (train[0][:b].contiguous(), train[1][:b].contiguous(), train[2])
        for b in (1, 3, 6)], ('trident_rpn_train', ) * 3)
    del model, train
    torch.cuda.empty_cache()
    n, _ = detector_steps(torch, smi, cfg, base, *YT_STEPS, per_step=1,
                          phase='tridentnet_train',
                          batch_size=TRIDENT_STEP_BATCH)
    launches += n
    # res5 runs on every roi of the three branches: the CPU's top 10
    roi_reference(torch, np, base, TRIDENT_CONFIG, 'tridentnet_reference',
                  proposals=10)
    trident_branch_reference(torch, np, base)
    del base
    torch.cuda.empty_cache()
    check(launches == YT_LAUNCHES, f'yolo_trident phase: {launches} '
          f'nms_keep launches, expected {YT_LAUNCHES}')
    emit(dict(phase='yolo_trident_done', seconds=time.perf_counter() -
              t_phase, budget_s=30, nms_keep_launches=launches))
    return launches, {(r['K'], r['B']): r for r in rows}


def run_phases(names):
    """`--phases NAME ...`: only the named phases (dcn, res2net, ddp,
    hrnet_regnet, resnet_variants, data_host, vfnet, guided_anchoring,
    reppoints, fovea_ssd, ms_rcnn_resnest, paa_fsaf_freeanchor, sabl,
    detectors_necks, grid_point_rend, libra_pisa, groie_mining,
    roi_variants, legacy_ghm, crpn_tood, yolo_trident, cascade),
    each with its seconds and
    launches, on the card with TF32 off and the kernel built; no result
    line."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from ld_tpu_torch.ops import nms_cuda
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    nms_cuda.build()
    phases = dict(dcn=lambda: phase_dcn(torch, smi),
                  res2net=lambda: phase_res2net(torch, np, smi),
                  ddp=lambda: phase_ddp(torch, np, smi),
                  hrnet_regnet=lambda: phase_hrnet_regnet(torch, np, smi),
                  resnet_variants=lambda: phase_resnet_variants(torch, np,
                                                                smi),
                  data_host=lambda: phase_data_host(torch, np, smi),
                  vfnet=lambda: phase_vfnet(torch, np, smi),
                  guided_anchoring=lambda: phase_guided_anchoring(
                      torch, np, smi),
                  reppoints=lambda: phase_reppoints(torch, np, smi),
                  fovea_ssd=lambda: phase_fovea_ssd(torch, np, smi),
                  ms_rcnn_resnest=lambda: phase_ms_rcnn_resnest(
                      torch, np, smi),
                  paa_fsaf_freeanchor=lambda: phase_paa_fsaf_freeanchor(
                      torch, np, smi),
                  sabl=lambda: phase_sabl(torch, np, smi),
                  detectors_necks=lambda: phase_detectors_necks(torch, np,
                                                                smi),
                  grid_point_rend=lambda: phase_grid_point_rend(torch, np,
                                                                smi),
                  libra_pisa=lambda: phase_libra_pisa(torch, np, smi),
                  groie_mining=lambda: phase_groie_mining(torch, np, smi),
                  roi_variants=lambda: phase_roi_variants(torch, np, smi)[0],
                  legacy_ghm=lambda: phase_legacy_ghm(torch, np, smi),
                  crpn_tood=lambda: phase_crpn_tood(torch, np, smi),
                  yolo_trident=lambda: phase_yolo_trident(torch, np,
                                                          smi)[0],
                  cascade=lambda: phase_cascade(torch, np, smi)[0])
    for name in names:
        t = time.perf_counter()
        launches = phases[name]()
        torch.cuda.empty_cache()
        emit(dict(phase=f'{name}_alone', nvidia_smi=smi, launches=launches,
                  seconds=time.perf_counter() - t))
    return 0


def main():
    import torch
    if len(sys.argv) > 1 and sys.argv[1].startswith('--ddp-'):
        return ddp_worker(sys.argv[1:])
    if len(sys.argv) > 1 and sys.argv[1] == '--phases':
        return run_phases(sys.argv[2:])
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, ROOT)
    from ld_tpu_torch.ops import nms_cuda

    t_script = time.perf_counter()
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

    max_err, main_case, tta_case, k16800 = phase_kernel(torch)
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    harness_launches, harness_work, _ = phase_harness(torch, smi)
    emit(dict(phase='harness_done', seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    landscape_launches = phase_landscape(torch, smi, harness_work)
    emit(dict(phase='landscape_done', seconds=time.perf_counter() - t0))
    shutil.rmtree(harness_work, ignore_errors=True)
    torch.cuda.empty_cache()
    serve_http_launches, export_launches = phase_deploy(torch, np, smi)
    torch.cuda.empty_cache()
    classic_launches = phase_classic_heads(torch, np, smi)
    torch.cuda.empty_cache()
    two_stage_launches, k4819 = phase_two_stage(torch, np, smi)
    torch.cuda.empty_cache()
    mask_rcnn_launches = phase_mask_rcnn(torch, np, smi)
    torch.cuda.empty_cache()
    cascade_launches, cascade_k = phase_cascade(torch, np, smi)
    torch.cuda.empty_cache()
    hrnet_regnet_launches = phase_hrnet_regnet(torch, np, smi)
    torch.cuda.empty_cache()
    resnet_variants_launches = phase_resnet_variants(torch, np, smi)
    torch.cuda.empty_cache()
    data_host_launches = phase_data_host(torch, np, smi)
    torch.cuda.empty_cache()
    vfnet_launches = phase_vfnet(torch, np, smi)
    torch.cuda.empty_cache()
    ga_launches = phase_guided_anchoring(torch, np, smi)
    torch.cuda.empty_cache()
    reppoints_launches = phase_reppoints(torch, np, smi)
    torch.cuda.empty_cache()
    fovea_ssd_launches = phase_fovea_ssd(torch, np, smi)
    torch.cuda.empty_cache()
    ms_resnest_launches = phase_ms_rcnn_resnest(torch, np, smi)
    torch.cuda.empty_cache()
    pff_launches = phase_paa_fsaf_freeanchor(torch, np, smi)
    torch.cuda.empty_cache()
    sabl_launches = phase_sabl(torch, np, smi)
    torch.cuda.empty_cache()
    dn_launches = phase_detectors_necks(torch, np, smi)
    torch.cuda.empty_cache()
    gp_launches = phase_grid_point_rend(torch, np, smi)
    torch.cuda.empty_cache()
    lp_launches = phase_libra_pisa(torch, np, smi)
    torch.cuda.empty_cache()
    gm_launches = phase_groie_mining(torch, np, smi)
    torch.cuda.empty_cache()
    var_launches, c4_rows = phase_roi_variants(torch, np, smi)
    torch.cuda.empty_cache()
    lg_launches = phase_legacy_ghm(torch, np, smi)
    torch.cuda.empty_cache()
    ct_launches = phase_crpn_tood(torch, np, smi)
    torch.cuda.empty_cache()
    yt_launches, trident_rows = phase_yolo_trident(torch, np, smi)
    emit(dict(phase='script_done', seconds=time.perf_counter() - t_script))

    print(smi.splitlines()[0], flush=True)
    emit(dict(kernels=[dict(
        name='nms_keep', route='cuda', source='ld_tpu_torch/csrc/nms_keep.cu',
        replaces='ld_tpu/ops/pallas_nms.py:23',
        launches=(launches + train_launches + runtime_launches +
                  voc_launches + family_launches + bf16_launches +
                  dcn_launches + res2net_launches + ddp_launches +
                  harness_launches + landscape_launches +
                  serve_http_launches + export_launches + classic_launches +
                  two_stage_launches + mask_rcnn_launches +
                  cascade_launches + hrnet_regnet_launches +
                  resnet_variants_launches + data_host_launches +
                  vfnet_launches + ga_launches + reppoints_launches +
                  fovea_ssd_launches + ms_resnest_launches +
                  pff_launches + sabl_launches + dn_launches +
                  gp_launches + lp_launches + gm_launches +
                  var_launches + lg_launches + ct_launches +
                  yt_launches),
        launches_serve=launches, launches_train=train_launches,
        launches_runtime=runtime_launches, launches_voc=voc_launches,
        launches_gfl_family=family_launches, launches_bf16=bf16_launches,
        launches_dcn=dcn_launches, launches_res2net=res2net_launches,
        launches_ddp=ddp_launches, launches_harness=harness_launches,
        launches_landscape=landscape_launches,
        launches_serve_http=serve_http_launches,
        launches_export=export_launches,
        launches_classic_heads=classic_launches,
        launches_two_stage=two_stage_launches,
        launches_mask_rcnn=mask_rcnn_launches,
        launches_cascade=cascade_launches,
        launches_hrnet_regnet=hrnet_regnet_launches,
        launches_resnet_variants=resnet_variants_launches,
        launches_data_host=data_host_launches,
        launches_vfnet=vfnet_launches,
        launches_guided_anchoring=ga_launches,
        launches_reppoints=reppoints_launches,
        launches_fovea_ssd=fovea_ssd_launches,
        launches_ms_rcnn_resnest=ms_resnest_launches,
        launches_paa_fsaf_freeanchor=pff_launches,
        launches_sabl=sabl_launches,
        launches_detectors_necks=dn_launches,
        launches_grid_point_rend=gp_launches,
        launches_libra_pisa=lp_launches,
        launches_groie_mining=gm_launches,
        launches_roi_variants=var_launches,
        launches_legacy_ghm=lg_launches,
        launches_crpn_tood=ct_launches,
        launches_yolo_trident=yt_launches,
        max_abs_err=max_err, ms=main_case['ms'],
        plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
        bound_by=main_case['bound_by'], library_ms=None,
        device_ms=main_case['device_ms'], host_ms=main_case['host_ms'],
        host_ms_launch=main_case['host_ms_launch'],
        dispatch_host_ms=main_case['dispatch_host_ms'],
        **{f'device_ms_{n}': main_case[f'device_ms_{n}']
           for n in NMS_KERNELS},
        ms_k2048=tta_case['ms'], device_ms_k2048=tta_case['device_ms'],
        plain_ms_k2048=tta_case['plain_ms'],
        bound_ms_k2048=tta_case['bound_ms'],
        **{f'{key}_k16800': k16800[key]
           for key in ('ms', 'host_ms', 'device_ms', 'plain_ms', 'bound_ms',
                       *(f'device_ms_{n}' for n in NMS_KERNELS))},
        ms_tta_merge=merge['ms'], device_ms_tta_merge=merge['device_ms'],
        plain_ms_tta_merge=merge['plain_ms'],
        **{f'{key}_k4819{"" if b == 1 else "_b2"}': k4819[b][key]
           for b in (1, 2)
           for key in ('ms', 'host_ms', 'device_ms', 'plain_ms',
                       'bound_ms')},
        **{f'{key}_{row["set"]}_b2': row[key] for row in cascade_k
           for key in ('K', 'ms', 'host_ms', 'device_ms', 'plain_ms',
                       'bound_ms')},
        **{f'{key}_k{k}{"" if b == 1 else "_b2"}': row[key]
           for (k, b), row in c4_rows.items()
           for key in ('ms', 'host_ms', 'device_ms', 'plain_ms', 'bound_ms',
                       'bound_by')},
        **{f'{key}_trident_k{k}_b{b}': row[key]
           for (k, b), row in trident_rows.items()
           for key in ('ms', 'host_ms', 'device_ms', 'plain_ms', 'bound_ms',
                       'bound_by')})]))
    emit(dict(ok=True, device=dict(platform='gpu',
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
