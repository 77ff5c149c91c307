#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's eval render paths, its training step, its
``train_nerf`` and ``eval_nerf`` CLIs and the README's Quickstart commands on
one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA card
    python3 chip_smoke.py --dp     # phases 15 and 16 alone, on every card there is
    echo go | python3 chip_smoke.py --scatter-parts   # 14a's scatter parts, profiled (JSON)

Three render configurations: Blender vanilla (frequency encoder, 8x256 MLP), the
contracted K-Planes-hybrid unbounded-360 one (planes (64, 128) x 8, lines
512 x 16, hybrid L=6, aabb 2.0, mip-NeRF 360 contraction, disparity-linear
samples from 0.125 to 22.5, an 8x256 MLP on the 71 encoder columns), and
mip-NeRF's integrated positional encoding on Blender (the vanilla recipe with
``ipe=True``: each sample a conical-frustum Gaussian over its interval, per-ray
pixel-cone radii). Training runs ``bench.py``'s recipe (phase 8), bare and
through the CLI (phase 9).

Phases (any failure exits non-zero):

1. device line: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel of ``nerf_sandbox_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) and prints, from each
   library's ``-Xptxas -v`` report (kept beside it, so a cached build reports
   too), every kernel's registers, spills and wgmma-serialization notes
   (C7510-C7520), and each route's ring of weight stages in K1 and K2 as the
   built libraries plan it; fails on a spill anywhere, and on a note that
   says an instantiation's wgmmas are serialized;
3. K1 (fused MLP) against its plain PyTorch version at 16384x64 rows with the
   reference's 8x256 weights (``tests/golden/mlp_state.npz``), max |diff|
   <= 0.05, timed with CUDA events (median of 10 after warm-up); beside it,
   as a yardstick the port never calls, the same MLP as a chain of bf16
   cuBLAS calls layer by layer;
4. K2 (fused ray-march) against its plain version on one real eval tile
   (16384 rays x 192 merged samples of frame 1): comp, w, acc 2e-2 and depth
   0.1; early ray termination (eps 1e-4) against none within 1e-3, on the
   reference weights and on a dense variant where ERT fires; timed. For K1
   and every K2 tile timed here and in 4b / 4c a line gives the rows per
   weight fetch, the weight bytes the call pulls from L2 with the rate that
   implies, and the share of the bound;
4b. the 360 configuration with seeded weights, on one real fine tile of its
   frame 1 (16384 x 192): K2 with K2c + K3 against its plain version at
   phase 4's tolerances; K3's encode-only entry on the same (contracted)
   points bit for bit; K2c alone (the frequency model, contracted)
   and K3t (a 4-D grid, time_res 8, time tables N(1, 0.1), folded at
   t = 0.37, finite last bin; Σw·z held at 2e-2 x far) against their plain
   versions; the coarse tile (16384 x 64) against its plain version; each
   timed, with its bound. K3 encode-only by its device time (a CUDA graph
   of 20 calls), beside the event time of one call and the profiler's time
   of one launch (here only), with the table read rate (``k3_times``);
4c. K4 (the IPE encode inside K2) on phase 4's fine tile with the radii
   ``pixel_cone_radii(FOCAL, |d|)``, against its plain version at phase 4's
   tolerances, ERT (eps 1e-4) against none within 1e-3, and K4 with
   contraction on phase 4b's tile (frequency model); each timed beside the
   frequency tile, with its bound;
5. the slice: ``render_pose`` of two 800x800 Blender-style poses through K2
   (``EvalHyper`` vanilla, ``use_kernel=True``) and one
   ``nerf_forward_pass(use_kernel=True)`` over a fine tile through K1, with
   the launch counters zeroed just before and read just after; frames must
   be finite and in [0, 1], and frame 1 rendered through the plain path
   (``use_kernel=False``) must agree within 2e-2 and at >= 40 dB PSNR; then
   one more frame under ``torch.profiler``: device time by kernel and the
   device's idle share (or "not measured" if the trace holds no CUDA time);
5b. the same for the 360 configuration: two 800x800 orbit poses at radius 1
   through K2's k-planes + contraction instantiation (80 launches a frame),
   and one k-planes ``nerf_forward_pass(use_kernel=True)`` through K3's
   encode-only entry and K1, counters zeroed just before and read just
   after (per route: phase 5 must run only the frequency instantiation,
   5b only the k-planes one); frame 1 against the plain path as in 5; then
   one frame of phase 4b's 4-D model at t = 0.37, every launch folding;
5c. the IPE slice: two 800x800 Blender poses through ``render_pose`` with
   ``EvalHyper(ipe=True, use_kernel=True)`` (80 K2 launches a frame, every
   one on route ``ipe``) and one ``nerf_forward_pass(ipe=True,
   use_kernel=True)`` through K1, counted as in 5; frame 1 against the plain
   path as in 5;
5w. hidden widths 384 and 512 (K1 and K2's wide instantiations): K1 at
   2^20 rows of 8x384 and 8x512 skip-4 MLPs with seeded weights, beside the
   bf16 cuBLAS chain, and one 8x512 and one 8x384 Blender fine tile (phase
   4's) on the frequency route, against their plain versions (phase 3's and
   phase 4's tolerances), timed with their bounds, each with the bytes its
   wgmmas read from shared memory and the rate that implies
   (``wide_smem_bytes``); then one 800x800 frame of the 8x512 model through
   ``render_pose`` (80 frequency launches), the 8x384 model through
   ``render_rays_chunked`` on that tile's 16384 rays (two K2 launches) and
   each width's ``nerf_forward_pass(use_kernel=True)`` through K1, counted;
5x. hidden widths above 512 (the large route of K1 and K2, activations in
   global scratch): K1 at 2^20 rows of 8x640 and 8x1024 skip-4 MLPs with
   seeded weights and one 8x1024 Blender fine tile (phase 4's) on the
   frequency route, against their plain versions (phase 3's and phase 4's
   tolerances; depth held as Σw·z at 2e-2 x far, since the seeded model
   leaves rays nearly transparent), timed with their bounds, each with the
   bytes its weight stream and its activation scratch move and the rates
   they imply (``fetch_line``, ``scratch_bytes``), K1 beside the bf16
   cuBLAS chain at each width; then, counted, the 8x1024 model
   through ``render_rays_chunked`` on that tile's 16384 rays (two K2
   launches, both on the large route) and each width's
   ``nerf_forward_pass(use_kernel=True)`` through K1;
5b4. the 360 configuration with 4-feature planes: K2c + K3 on phase 4b's
   fine tile against its plain version, K3's encode-only entry bit for bit,
   timed as in 4b; one 800x800 frame through ``render_pose`` and one
   ``nerf_forward_pass`` through K3 + K1, counted;
7. K5, the precision probe: ``a @ b`` on the TPU probe's three shapes in
   the modes bf16, tf32, bf16x3 and fp32, each launch counted, its error
   against the fp64 oracle printed and each output held against its plain
   version within K 2^-23 sum|a||b|; each shape timed in every mode beside
   ``torch.matmul`` on the same shape;
8. training (``train/step.py``) on ``bench.py``'s recipe: its synthetic
   4-frame 800x800 scene, 1024 rays, 8x256, 64 + 128 samples, sigma noise,
   bf16 MLP, Adam 5e-4 with the cosine schedule; 10 warm-up steps and 50
   timed ones: ms/step, train ray-samples/s (rays x (64 + 192) / s, as
   bench.py counts), peak memory; every loss finite, every tensor of the
   state on the card, no kernel launch counted (the JAX train step runs no
   Pallas kernel either); five steps under ``torch.profiler``; one step from the same state and draws on the
   card and on the CPU, loss and PSNR at rtol 1e-2, the gradients within
   5e-2 of their norm together, each array within 0.3 of its norm and at a
   cosine >= 0.95 (JAX's own jitted and op-by-op bf16 steps differ by 1.3%,
   14.8% and 0.989); then the chunk (``build_train_step(scan_steps=16)``, on
   the card one CUDA graph of 16 steps, ``phase_train_chunk``): two eager
   runs of 16 steps from one state bit-equal (or their spread printed), the
   captured chunk from the same state bit-equal to them or within that
   spread (state and metrics), ms/step over 4 chunks, ray-samples/s, peak
   memory and one profiled chunk beside the eager figures; a 360 k-planes
   state with one texel at inf through its own chunk: 16 skipped, every
   tensor held, the step advanced by 16;
9. the CLI (``scripts/train_nerf.py``), in-process: bench.py's scene written
   as a Blender dataset by ``data/png.py`` and read back bit for bit; 200
   ``--vanilla`` steps with checkpoints every 100, a scored validation on the
   plain path and one progress frame through K2, the steps dispatched in
   chunks of 16 from step 101 exactly as JAX's rule (``predicted_dispatches``)
   places them; ``--resume latest`` to 220 (must start at 201 and chunk
   201-216); ``--render_only`` with two 800x800 path frames through K2; 40
   steps in chunks of 4 with two validations through K2, synchronous and
   ``--async_val true``, byte-identical validation PNGs. Loss at steps 1 and
   200 (must fall), val PSNR / SSIM, ms/step through the CLI beside phase
   8's, s/frame, checkpoint sizes; K2's launches in each run must equal the
   kernel gate's prediction;
9b. the unbounded-360 k-planes recipe through the CLI with ``--eval_kp_pool
   2 --val_res_scale 0.5``: 20 steps, a 400x400 validation through K2, one
   ``--render_only`` frame at 200x200; every K2 launch on the k-planes +
   contraction route and on the pooled (32, 64) planes, as the gate
   predicts; the pooled path frame against its plain version;
11. the README's Quickstart commands through the CLI (``phase_quickstart``):
   11a, Blender: phase 9's scene with ``--vanilla --use_tb
   --render_path_after --progress_video_during_training``, cut to 40
   steps, 4 path frames (4 progress, 4 camera path), 2 validation events
   and a log line every 10 steps; the event file read by the script's own
   reader (``read_events``, every masked CRC32C checked) must hold the
   loop's loss, PSNR and lr as float32 at every log step, the card's
   memory and each validation's images (800 -> 512) and PSNR / SSIM; the
   GIFs of the camera path, the progress video and the validation frames,
   decoded by ``read_gif``, one frame per PNG less merged duplicates, delay
   0, no loop block, gray frames bit-equal to their PNGs, RGB >= 30 dB;
   K2's launches the gate's prediction (TensorBoard and GIFs launch
   nothing); 11b, fern: a synthetic forward-facing scene at fern's
   ``images_8`` size (504x378, 8 views) written with gAMA 0.45455 PNGs,
   its images held against imageio's gamma formula, then ``--data_kind
   llff --downscale 8 --use_ndc --ndc_near_plane_world 1.0 --vanilla
   --use_tb`` for 40 steps (the loss must fall, the events as in 11a), and
   the committed JPEG at that size decoded bit-equal to imageio's pixels
   (sha256) and timed; the seconds of TensorBoard writing per event and of
   GIF packing per frame; 11c, fern from JPEGs (``phase_jpeg_tail``): the
   fixtures of ``tests/golden/jpeg_tail`` (the 8 fern-size views as
   progressive, optimized with restarts, smoothed, arithmetic sequential
   and progressive, 4:4:0, 4:1:1 and chroma-above-luma files; small CMYK,
   YCCK and lossless ones) decoded to imageio's sha256, each timed, the 8
   refused kinds raising; then the fern flags on those 8 views for 30
   steps (the loss must fall, K2 only the probe's 2);
12. slice 9, SH view directions, appearance codes and camera refinement:
   12a, K2 on phase 4's fine tile with seeded 8x256 models whose view
   directions are SH-encoded at degrees 4, 1, 2 and 3 (16, 1, 4, 9
   columns, padded to 32) against its plain version, and on an 8x256 model
   with 16-wide appearance codes folded with a fixed code against the plain
   forward of the unfolded model fed that code (comp, w, acc 2e-2, depth as
   Σw·z at 2e-2 x far, the kink held apart; ERT against none within 1e-3),
   each timed beside the 27-column tile and its bound; counted, the SH d = 4,
   SH d = 1 and folded models through ``render_rays_chunked`` (2 K2
   launches each) and K1 through ``nerf_forward_pass`` on the SH and folded
   models; 12b, the CLI on phase 9's scene with ``--dir_enc sh
   --appearance_dim 16 --pose_opt true --barf_anneal_steps 200``, 132 steps
   (100 eager, 2 chunks of 16 while BARF ramps), the loss falling, every
   table row moved, both tables in the checkpoints under JAX's keys,
   ``--resume latest`` from 100 bit-equal to the straight run (or within
   two straight runs' spread), K2's launches as the gate predicts, and a
   ``--render_only --eval_appearance 1`` path frame through K2 against the
   plain render of the unfolded models fed frame 1's code (2e-2 off the
   kink, >= 40 dB); 12c, the captured 16-step chunk with all four options
   and BARF over 64 steps against 16 eager steps, bit-equal (or within two
   eager runs' spread), ms/step beside phase 8's;
13. held-out evaluation, the test-time refiners and the mesh export
   (``phase_eval``): 13a ``eval_nerf --split test --val_exact false
   --refine_pose 50 --refine_appearance 50`` on phase 12b's run with a
   2-frame test split, its metrics.json, K2's launches (2 x 80, no K1),
   the triplets, ``run_debug.json`` untouched and no ``tb/``, seconds a
   frame of refining and of rendering, and K2 on phase 4's tile with the
   run's folded eval model against its plain version; 13b frame 0 scored at
   half size through K2 and through the plain tile, held at 12b's gates;
   13c both refiners on the card against the CPU on a seeded 8x256 model
   (the code end to end, the pose step by step), ms a refine step; 13d
   ``--render_only --export_mesh --mesh_res 128`` on phase 9's run, the
   sweep's and the isosurfacer's seconds, the σ grid at res 32 on the card
   against the CPU's;
14. ``--encoder hashgrid`` at the CLI's default widths (16 levels x 2^19
   rows x 2 features, resolutions 16 to 512; ``phase_hash``): 14a the
   encode on the card against the CPU at a vanilla step's 65,536 and
   196,608 points, and the table-gradient scatter (``csrc/hash_scatter.cu``,
   port-only kernels: the pairs counted, scanned and partitioned into
   buckets of rows in flat order, each bucket's rows summed in one fixed
   order) on 25.2 M pairs of a typical, a collision-heavy and a
   beyond-the-box batch, bit-equal to its plain version on CPU copies and
   across two runs, timed with its parts (count, scan, partition, sum by
   the profiler) beside ``index_add_``; 14b ``train_nerf
   --vanilla --encoder hashgrid --lr_grid 1e-2``, 100 eager steps and a
   chunk, ``--resume`` and ``--render_only``, K2 launching nowhere (the
   gate refuses hash grids) and the scatter in every training window, the
   train step's own scatters (longest run, ms, bit-equal to the plain
   version and across two runs), a 16-step chunk bit-equal to 16
   eager steps, ms/step eager and chunked, the frame's seconds and the
   encode's share; 14c ``--sampling occupancy`` with the updater's ms,
   ``--export_mesh --mesh_res 128`` with the σ grid card vs CPU, and one
   step of each refiner card vs CPU;
15. data parallel over rays (``parallel/``; ``phase_dp``), at phase 8's
   recipe and phase 5's frame: 15a two ranks (each on its own card over
   NCCL with two cards or more; both on card 0 over gloo, asked for by
   name, with one; spawned by ``torch.multiprocessing``): 20 eager steps,
   the parameters bit-equal across ranks and to 20 single-rank steps in
   this process on the same draws in 2 micro-chunks (the ranks' rows: bf16
   rounds each rank's weight gradients before the sum, as it rounds each
   micro-chunk's), and within a stated bound of the whole-batch
   single-rank run (``DP_WHOLE_*``), which a run on one rank's share of
   rays must break; the frame-sharded bank (the other rank's frames zeroed) giving
   the same losses, ms/step at world 2 beside world 1 and the all-reduce
   alone; one 800x800 frame through K2
   from the ranks' shares against phase 5's single-rank frame (2e-2 off the
   kink, >= 40 dB), each rank's K2 launches as the shares predict, and K2 on
   one share of phase 4's tile (its kernels-line row ``fused_raymarch_dp``:
   against its plain version, and against the same rays of the whole tile,
   bit for bit); 15b an NCCL group over the cards there are (a world of 1
   on one card, still summing), phase 8's chunk of 16 steps captured with
   the sum inside against 16 eager steps bit for bit, ms/step and idle
   share beside phase 8's chunk; 15c the CLI on two ranks (with two cards
   ``--mesh_devices 2`` through the launcher; with one, ``--mesh_devices
   2`` refused, then two processes on card 0 each opening its gloo group
   and calling ``train_nerf --multihost``): 40 ``--vanilla`` steps with a
   progress frame, ``--resume latest`` to 48, one ``--render_only`` frame,
   one checkpoint set, ``out_dir/proc1`` only in the ``--multihost`` run
   and only with what JAX's process 1 writes, the states bit-equal across
   ranks and rank 0's K2 launches as predicted; 15d, with four cards or
   more, ``--mesh_slices 2`` over every card against the flat sum (step
   1's gradients within 1e-6, every rank bit-equal). Phases 9-14 call the CLIs
   through ``run`` (this process as one rank on card 0), so a machine with
   more cards runs them as one card does; phase 15 spreads over them;
16. tensor parallel over a model axis (``--mesh_model 2``, ``phase_tp``):
   with one card two ranks on card 0 over gloo (data 1 x model 2), with
   four cards or more four over NCCL (data 2 x model 2), spawned as in 15;
   16a phase 8's recipe cut over the model axis (trunk column / row pairs),
   10 eager steps against 10 one-rank steps on the same draws in this
   process within 15a's whole-batch bound, the whole state equal on every
   rank, the uncut tensors on the model ranks and everything on the data
   ranks bit-equal; ms/step beside one rank, a row layer's sum over the
   model axis alone (ms, bytes) and each rank's parameter bytes beside the
   whole model's; 16b phase 5's models cut, rendering on the plain tile in
   fp32 (the 800x800 frame over NCCL; its 64x64 middle over gloo, which
   moves every cut layer's sum through the host) against the whole models'
   render at 1e-4, K1 and K2 counted 0; 16c the README's unbounded-360
   occupancy command (``_occ_argv``: planes (64, 128) x 8 and lines 16
   cut 2 ways) with ``--mesh_model 2`` through ``train_nerf.run
   --multihost`` on the ranks' group, 20 steps (chunks of 8 over NCCL,
   eager over gloo, which cannot be captured), ``--resume latest`` to 24,
   one ``--render_only`` frame, frames at 50x50, one checkpoint set, which
   a one-rank trainer here loads into the state the ranks gathered; 16d
   BASELINE.json's hash configuration (``_hash_argv``) with ``--mesh_model
   2``, 8 steps, the tables cut to (16, 2^19, 1) on each rank, the
   table-gradient scatter launched on every rank, and on such a piece at a
   fine pass's 25.2 M pairs bit-equal to its plain version (its
   kernels-line row ``hash_scatter_tp``); 16e an NCCL group (world 1 on
   one card, the model axis of one rank; data 2 x model 2 with four
   cards), phase 8's chunk of 16 steps captured with the model axis' sums
   and the data axis' sum inside against 16 eager steps bit for bit, then
   the graphs freed before the group; 16f with four cards the 8x1024 trunk
   cut 4 ways: each rank's pieces and bytes, 10 steps against one rank;
17. checkpoints and signals (``phase_17``): 17a ``--vanilla`` on
   ``bench.py``'s scene with ``--ckpt_backend orbax --ckpt_every 20
   --ckpt_max_to_keep 2`` for 60 steps, then ``--resume latest`` to 80,
   against the same under npz: each orbax step (read before retention
   drops it) bit-equal to the npz file of its step, only the newest two
   kept, each backend's seconds a save holds the loop and bytes a step,
   and one ``--render_only`` frame from the orbax step whose K2 launches
   are the start-up probe's plus ``k2_launches(H, W, 2)``; 17b two ranks
   on card 0 over gloo with ``--mesh_model 2`` (2 x 2 over NCCL in
   captured chunks with four cards), SIGUSR1 sent to rank 1's pid, then
   SIGINT to rank 0's: both ranks save at the same step and stop at the
   same step, each tagged file bit-equal to a one-rank trainer's save of
   the gathered state and, cut back into pieces, to each rank's own
   tensors, and the agreement alone timed; 17c two pairs of
   ``--multihost`` processes at once (gloo on card 0; NCCL in captured
   chunks on two cards) with the heartbeat limit cut to ``HB_LIMIT_S``,
   rank 1 of one pair killed with SIGKILL mid-run and of the other
   stopped with SIGSTOP (its sockets stay open, so only the heartbeat
   can end its peer): each survivor must exit non-zero within the limit
   plus ``HB_GRACE_S``, the stopped one's peer with the heartbeat's
   ``[dist]`` line;
6. a ``{"kernels": [...]}`` JSON line with each kernel's launches on its
   path (K2's from phase 11a's window; its phase-12 rows
   ``fused_raymarch_sh4``, ``_sh1`` and ``_app`` from 12a's counted
   window, its phase-13 row ``fused_raymarch_eval`` from 13a's, its
   phase-15 row ``fused_raymarch_dp`` from rank 0 of 15a's frame, the
   scatter's from 14b's first training window, its phase-16 row
   ``hash_scatter_tp`` from rank 0 of 16d's run), max |diff|
   against its plain version, its time, the plain
   version's time, the card's bound for the same work and, where one
   PyTorch call computes the same function, that call's time; then the
   last line ``{"ok": true, "device": {...}}``.

The infinite last bin makes a ray's composite a step function of the sign of
its last sigma logit (``last_bin_kink``). Rays whose logit is closer to zero
than twice the measured kernel-vs-plain logit difference are counted (at
most 5% allowed) and held on every sample but the last (phase 4) or by the
frame PSNR (phase 5); every other ray is held at the tolerances above. With
IPE the last sample's encoding depends on its interval, so the band is
measured on the last sample's frustum Gaussian of each pass.

There is no CPU path: without a CUDA device, or without the package beside
this script, it prints nothing on stdout and exits 2.
"""

import json
import os
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12        # HBM3 bandwidth, H100 SXM
H100_SMS = 132                  # streaming multiprocessors, H100 SXM
N_POSES = 2
IMG = 800
FOCAL = 1111.1
EVAL_CHUNK = 16384
NEAR_360, FAR_360 = 0.125, 22.5   # RESULTS.md "norm": the rig scaled to r = 1


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps=10):
    """Median time of ``fn`` on the card over ``reps`` runs, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(torch, fn, n=100):
    """Device time of one call of ``fn``, from a CUDA graph of ``n`` calls
    replayed as in ``cuda_ms``: for launches shorter than the host's own
    overhead per call, which events around single calls would measure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay) / n


def mlp_macs_per_row(cfg):
    """Unpadded multiply-adds of the skip MLP per sample row (vanilla:
    593,408)."""
    from nerf_sandbox_tpu_torch.models.mlp import trunk_in_dims
    H = cfg.hidden_dim
    return (sum(d * H for d in trunk_in_dims(cfg)) + H * H + H
            + (H + cfg.enc_dir_dim) * (H // 2) + (H // 2) * 3)


def bound(flops, nbytes, fp32_flops=0.0):
    """Least time (ms) for the work: the larger of the bytes over HBM's rate
    and the operations over their unit's peak (bf16 tensor cores, fp32)."""
    t_ops = max(flops / H100_BF16_FLOPS, fp32_flops / H100_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_passes(B, N):
    """MLP passes of K2 over B rays x N samples (no ERT): each pass is one
    weight fetch for 32 rays x 4 samples."""
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    return -(-B // fr.RAYS_PER_GROUP) * -(-N // fr.SAMPLES_PER_PASS)


def scratch_bytes(cfg, passes):
    """The large route's activation traffic in ``passes`` MLP passes of
    ``TILE_M`` rows: each consumer warpgroup's 64 x H bf16 input is read
    from its scratch once per output chunk (``large_chunks``) by every layer
    after the first and the feature layer (H wide) and by the colour head
    (H / 2 wide), and each of the n_layers + 1 trunk outputs is written once.
    → (bytes read, bytes written)."""
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    H = cfg.hidden_dim
    per_read = passes * fm.TILE_M * H * 2
    chunks = cfg.n_layers * len(fm.large_chunks(H)) + len(fm.large_chunks(H // 2))
    return per_read * chunks, per_read * (cfg.n_layers + 1)


def wide_smem_bytes(cfg, passes):
    """The wide path's wgmma operand reads from shared memory in ``passes``
    MLP passes of ``TILE_M`` rows: each consumer warpgroup reads its A (64
    rows x 64 K, 8 KiB) once per stage, a stage being NCW columns of an
    output chunk (``large_chunks``) per 64 K rows, and every stage's B (64 K
    x its columns) once. The matmuls' K, padded to 64, and N: layer 0 (EP),
    the trunk's layers (H, H + EP at the skip), the feature layer (H) and the
    colour head (H + EDP, H / 2). → (A bytes, B bytes)."""
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    H = cfg.hidden_dim
    ep, ed = fm._enc_pads(cfg)
    edp = -(-ed // fm.KC) * fm.KC
    ks = [ep] + [H + ep if l == cfg.skip_pos else H for l in range(1, cfg.n_layers)]
    a = b = 0
    for k, n in zip(ks + [H, H + edp], [H] * (cfg.n_layers + 1) + [H // 2]):
        stages = sum(-(-c // fm.NCW) for c in fm.large_chunks(n))
        a += fm.WG_ROWS * k * 2 * stages
        b += k * n * 2
    return passes * fm.N_CONSUMERS * a, passes * fm.N_CONSUMERS * b


def fetch_line(tag, ms, bound_ms, passes, packed, card):
    """Rows per weight fetch, the weight bytes a call pulls from L2 (the
    staged stream once per pass) and the rate that implies; on the wide path
    also the bytes its wgmmas read from shared memory and their rate (card-
    wide and per SM); on the large route the activation bytes read from (and
    written to) its scratch and the rate of both reads; the share of the
    bound."""
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    nbytes = passes * packed.staged.numel() * 2
    act = ""
    if packed.cfg.hidden_dim in fm.KERNEL_HIDDEN[2:]:
        a, b = wide_smem_bytes(packed.cfg, passes)
        act = (f"{(a + b) / 1e9:.3f} GB read from shared memory by wgmma (A "
               f"{a / 1e9:.3f}, B {b / 1e9:.3f}) = {(a + b) / ms / 1e9:.3f} TB/s, "
               f"{(a + b) / ms / 1e6 / H100_SMS:.1f} GB/s per SM; ")
    if fm.is_large(packed.cfg):
        rd, wr = scratch_bytes(packed.cfg, passes)
        act = (f"{rd / 1e9:.3f} GB of activations read from scratch ({wr / 1e9:.3f} "
               f"GB written): weights and activations {(nbytes + rd) / 1e9:.3f} GB "
               f"read = {(nbytes + rd) / ms / 1e9:.3f} TB/s; ")
    print(f"[{tag}] {fm.TILE_M} rows per weight fetch, {passes} fetches of "
          f"{packed.staged.numel() * 2 / 1e6:.3f} MB: {nbytes / 1e9:.3f} GB of "
          f"weights from L2 in {ms:.3f} ms = {nbytes / ms / 1e9:.3f} TB/s; {act}"
          f"{100.0 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms bound | {card}",
          flush=True)


def mlp_chain_bf16(torch, packed, ep, ed):
    """The same MLP as a chain of bf16 cuBLAS calls (addmm / mv) layer by
    layer, a yardstick for K1 that the port never calls. ep, ed: bf16 rows
    padded to the kernel widths."""
    v, cfg = packed.views, packed.cfg
    H = cfg.hidden_dim
    relu = torch.relu_
    h = relu(torch.addmm(v["b0"], ep, v["w0"]))
    mid = 0
    for layer in range(1, cfg.n_layers):
        if layer == cfg.skip_pos:
            h = relu(torch.addmm(torch.addmm(v["bskip"], h, v["wskip_h"]), ep,
                                 v["wskip_e"]))
        else:
            h = relu(torch.addmm(v["b_mid"][mid], h, v["w_mid"][mid]))
            mid += 1
    sigma = torch.mv(h, v["w_sig"]) + v["b_sig"]
    feat = torch.addmm(v["b_feat"], h, v["w_feat"])
    ch = relu(torch.addmm(torch.addmm(v["bc1"], feat, v["wc1"][:H]), ed,
                          v["wc1"][H:]))
    rgb = torch.addmm(v["bc2"], ch, v["wc2t"].T)
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def profile_frame(torch, render, tag, card):
    """One call of ``render`` (a frame, or training steps) under
    torch.profiler: device time by kernel and the device's idle share of
    its wall time. → (seconds in the fused ray-march kernels, profiled wall
    seconds, idle share), or None when the trace holds no CUDA time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print(f"[{tag}] torch.profiler: device time by kernel: not measured (the "
              f"trace shows no CUDA time); idle share: not measured", flush=True)
        return None
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    busy = sum(us for _, us in by_name.values()) / 1e6
    span = (max(e.time_range.end for e in dev_events)
            - min(e.time_range.start for e in dev_events)) / 1e6
    print(f"[{tag}] torch.profiler: wall {wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, idle share {100.0 * (1.0 - busy / wall):.1f}% "
          f"of the wall time ({100.0 * (1.0 - busy / span):.1f}% between the first "
          f"and the last kernel) | {card}", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{tag}]   {us / 1e3:10.3f} ms {100.0 * us / 1e6 / wall:5.1f}% "
              f"x{n:<5d} {name[:90]}", flush=True)
    k2 = sum(us for name, (_, us) in by_name.items() if "fused_raymarch" in name)
    return k2 / 1e6, wall, 1.0 - busy / wall


def kplanes_fp32_flops(kcfg):
    """fp32 operations of K3 per sample: per bilinear lookup 4 corners x F
    multiply-adds plus the second contraction, the products, the 4-D folds,
    the lines, and the hybrid channels (a sin or cos counted as one)."""
    F, Fl, n_s = kcfg.plane_features, kcfg.line_features, len(kcfg.plane_res)
    per_scale = 3 * (4 * 2 * F + 3 * F) + 2 * F
    if kcfg.time_res:
        per_scale += 3 * (2 * 2 * F + F)
    lines = 3 * 2 * 2 * Fl + 2 * Fl
    hybrid = 3 + 6 * kcfg.hybrid_freqs * 2 if kcfg.hybrid_freqs else 0
    return n_s * per_scale + lines + hybrid + 3 * (n_s + 1) * 8


def kplanes_table_bytes(kcfg):
    """Table bytes K3 reads per sample: 4 texels of F bf16 features per plane
    of each scale, 2 per time fold of a 4-D grid, 2 texels of Fl per line
    (576 B at planes (64, 128) x 8 and lines x 16, 384 B at 4 features)."""
    F, Fl, n_s = kcfg.plane_features, kcfg.line_features, len(kcfg.plane_res)
    per_scale = 3 * 4 * F * 2 + (3 * 2 * F * 2 if kcfg.time_res else 0)
    return n_s * per_scale + 3 * 2 * Fl * 2


def kernel_ms_of(torch, events, match):
    """Device time (ms) summed over the profiler's CUDA kernel events whose
    name contains ``match``, or None when the events hold none."""
    hits = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and match in e.name]
    if not hits:
        return None
    return sum(e.time_range.end - e.time_range.start for e in hits) / 1e3


def profiled_kernel_ms(torch, fn, match):
    """One call of ``fn`` under torch.profiler: the device time (ms) of its
    kernels whose name contains ``match``, or None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_ms_of(torch, prof.events(), match)


SCATTER_PARTS = {"count": "hash_scatter_count", "scan": "hash_scatter_scan",
                 "partition": "hash_scatter_partition", "sum": "hash_scatter_sum"}


def scatter_parts_child(torch):
    """``chip_smoke.py --scatter-parts``: phase 14a's typical batch (its
    draws: 25.2 M pairs of 16 x 2^19 x 2), drawn on the host, then, once a
    line "go" comes on stdin (the caller's card is idle then), through the
    table-gradient scatter once, then once under torch.profiler → prints
    one JSON object, the device ms of each part of :data:`SCATTER_PARTS`
    (sum: sum_big and sum), or null where the trace holds none."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    dev = torch.device("cuda")
    cfg = hg.HashGridConfig(aabb_scale=1.5)
    rng = np.random.RandomState(14)
    rng.uniform(-1.0, 1.0, (cfg.n_levels, cfg.table_size, cfg.n_features))  # 14a's tables
    rng.uniform(-1.6, 1.6, (65536, 3))                     # and its coarse pass's points
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (196608, 3)).astype(np.float32))
    if sys.stdin.readline().strip() != "go":
        return
    with torch.no_grad():
        keys = hg.corner_rows(pts.to(dev), cfg)[0].reshape(-1)
    vals = torch.randn((keys.numel(), cfg.n_features), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(14))
    n_rows = cfg.n_levels * cfg.table_size
    hs.hash_scatter(keys, vals, n_rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hs.hash_scatter(keys, vals, n_rows)
        torch.cuda.synchronize()
    events = prof.events()
    print(json.dumps({part: kernel_ms_of(torch, events, name)
                      for part, name in SCATTER_PARTS.items()}))


CHILDREN = []      # processes main() stops if they still run


def start_scatter_parts():
    """``chip_smoke.py --scatter-parts`` started (it draws its batch while
    phase 14a runs) → the process, for ``scatter_parts_ms``."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scatter-parts"],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc


def scatter_parts_ms(proc):
    """The table-gradient scatter's parts on phase 14a's typical batch, by
    the profiler in a process of its own (``start_scatter_parts``; on the
    H100 a process's later profiler sessions trace nothing): tells it to go
    → {part: ms or None}, None throughout if that process failed (its error
    printed)."""
    try:
        out, err = proc.communicate("go\n", timeout=300)
        if proc.returncode == 0:
            return json.loads(out.strip().splitlines()[-1])
        print(f"[hash] 14a the parts' process exited {proc.returncode}: {err[-2000:]}",
              flush=True)
    except (subprocess.TimeoutExpired, ValueError, IndexError) as e:
        print(f"[hash] 14a the parts' process failed: {e!r}", flush=True)
    return dict.fromkeys(SCATTER_PARTS)


def k3_times(torch, ke, grid, pts, ep, tag, card, profiled=False):
    """K3 encode-only on ``pts`` through the wrapper: its device time from a
    CUDA graph of 20 calls (``graph_ms``), the CUDA-event time of one call
    (``cuda_ms``, the wrapper's host time included) and the table read rate
    (``kplanes_table_bytes``) at the device time; with ``profiled``, the
    profiler's time of one launch too (the process's first profiler
    session: later ones have traced no K3 kernel on the H100), failing when
    the trace holds none. → (device ms, event ms)."""
    Q = pts.shape[0]

    def fn():
        return ke.fused_kplanes_encode(grid, pts, ep)

    dev_ms = graph_ms(torch, fn, n=20)
    ev_ms = cuda_ms(torch, fn)
    prof = ""
    if profiled:
        prof_ms = profiled_kernel_ms(torch, fn, "kplanes_encode")
        check(prof_ms is not None, f"[{tag}] the profiler traced no K3 kernel")
        prof = f", profiler kernel time {prof_ms:.4f} ms"
    per_row = kplanes_table_bytes(grid.cfg)
    print(f"[{tag}] encode-only {Q} rows: device {dev_ms:.4f} ms (CUDA graph of "
          f"20 calls), one call {ev_ms:.4f} ms (CUDA events, host included){prof}; "
          f"table reads {per_row} B a row, "
          f"{per_row * Q / 1e9:.3f} GB = {per_row * Q / dev_ms / 1e9:.3f} TB/s at "
          f"the device time | {card}", flush=True)
    return dev_ms, ev_ms


WGMMA_NOTE = re.compile(r"\((C75(?:1\d|20))\)")


def ptxas_entries(log):
    """Each compiled kernel of a ``-Xptxas -v`` report → {mangled name:
    {"regs", "spill_stores", "spill_loads", "notes"}}. A wgmma note of
    C7510-C7520 goes to the function it names, else to the entry being
    compiled; those that say the wgmmas are serialized are the ones that cost
    (C7519, "warpgroup.arrive is injected ...", marks the register hand-off
    of every register-operand wgmma and serializes nothing)."""
    rows, entry, props = {}, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            rows.setdefault(entry, dict(regs=None, spill_stores=0, spill_loads=0,
                                        notes=[]))
        elif "Function properties for" in ln:
            props = ln.rsplit(" ", 1)[-1].strip()
        elif "spill" in ln and props == entry and entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                rows[entry]["spill_stores"] = int(m.group(1))
                rows[entry]["spill_loads"] = int(m.group(2))
        elif "Used" in ln and "registers" in ln and entry:
            rows[entry]["regs"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        if WGMMA_NOTE.search(ln):
            named = re.search(r"'(_Z\w+)'", ln)
            key = named.group(1) if named else entry
            rows.setdefault(key, dict(regs=None, spill_stores=0, spill_loads=0,
                                      notes=[]))["notes"].append(ln.strip())
    return rows


def hidden_label(h):
    """A K1 / K2 instantiation's hidden width; 0 is the large route."""
    return "H>512, large route" if h == 0 else f"H={h}"


def kernel_label(mangled):
    """A readable name of K1's, K2's, K3's, K5's and the hash scatter's
    kernels and instantiations (else the mangled or plain name)."""
    k5 = re.search(r"precision_dot_kernelILi(\d)E", mangled)
    if k5:
        return f"K5 precision_dot<{('bf16', 'tf32', 'bf16x3', 'fp32')[int(k5.group(1))]}>"
    scatter = re.search(r"\d+(hash_scatter_[a-z_]+?)(?:ILi(\d+)E|E)", mangled)
    if scatter:
        part = scatter.group(1)
        if scatter.group(2) is None:
            return part
        return f"{part}<F={'any' if scatter.group(2) == '0' else scatter.group(2)}>"
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", mangled[m.end() + int(m.group(1)):]
                                        .split("EEv")[0] + "E")]
    if name == "fused_mlp_kernel" and len(args) == 1:
        return f"K1 fused_mlp<{hidden_label(args[0])}>"
    if name == "fused_raymarch_kernel" and len(args) == 3:
        enc = ("freq", "kplanes", "ipe")[args[0]]
        return (f"K2 fused_raymarch<{enc}{', contract' if args[1] else ''}, "
                f"{hidden_label(args[2])}>")
    if name == "kplanes_encode_kernel" and len(args) == 2:
        vf, vl = (str(a) if a else "any" for a in args)
        return f"K3 kplanes_encode<planes {vf}, lines {vl}>"
    return name


def build_notes(cuda_build):
    """Registers, spills and wgmma notes (C7510-C7520) of every kernel, from
    each library's persisted ``-Xptxas -v`` report (a cached build reports
    too); the notes that serialize wgmmas are printed in full. Fails on a
    spill anywhere and on a serializing note in any instantiation."""
    for src in cuda_build.SOURCES:
        log = cuda_build.build_log(src)
        check(log, f"no compiler report for {src}")
        for mangled, e in ptxas_entries(log).items():
            label = kernel_label(mangled)
            codes = {}
            for note in e["notes"]:
                code = WGMMA_NOTE.search(note).group(1)
                codes[code] = codes.get(code, 0) + 1
            serial = [n for n in e["notes"] if "serialized" in n]
            print(f"[build]   {src}: {label}: {e['regs']} registers, "
                  f"{e['spill_stores']} bytes spill stores, {e['spill_loads']} bytes "
                  f"spill loads, wgmma notes {codes or 'none'}, "
                  f"{len(serial)} serializing", flush=True)
            for note in serial:
                print(f"[build]     {note[:300]}", flush=True)
            check(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                  f"{label} spills registers")
            check(not serial, f"{label} serializes its wgmmas")


def ring_depths(cuda_build):
    """The weight stages each route of K1 and K2 holds in shared memory (the
    ring's depth), as the built libraries plan them (``nerf_ring_stages``)
    for an 8-layer MLP at each hidden-width route and the encoder widths the
    port pads to (64: frequency and IPE; 128: k-planes). → {(kernel, H,
    EP): stages}."""
    import ctypes
    k1, k2 = cuda_build.load("fused_mlp"), cuda_build.load("fused_raymarch")
    k1.nerf_ring_stages.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
    k2.nerf_march_extra.argtypes = []
    k2.nerf_march_extra.restype = ctypes.c_longlong
    extra = {"K1": 0, "K2": k2.nerf_march_extra()}
    depths = {(k, H, ep): k1.nerf_ring_stages(H, ep, 32, 8, x)
              for H in (128, 256, 384, 512, 640) for ep in (64, 128)
              for k, x in extra.items()}
    print(f"[build] weight stages in the ring by (kernel, H, EP) (H = 640: every "
          f"width of the large route): {depths}", flush=True)
    return depths


def last_bin_kink(pairs):
    """Rays too close to the infinite last bin's step to hold sample-exact.

    The last sample's delta is 1e10*|d|, so its alpha is a step in its sigma
    logit: 0 at or below zero, 1 above ~1e-8. Two correct implementations
    whose logits differ by rounding can fall on either side of zero there,
    and that ray's composite then differs by its whole last-bin term. For
    each (kernel, plain) pair of last-sample logits, the band is twice the
    largest |kernel - plain| measured on these very points; a ray is at the
    kink when its plain logit lies inside the band. → (mask, bands).
    """
    mask, bands = None, []
    for k, p in pairs:
        band = 2.0 * float((k - p).abs().max())
        m = p.abs() < band
        mask = m if mask is None else mask | m
        bands.append(round(band, 6))
    return mask, bands


NAMES = ("comp", "w", "acc", "depth")


def hold_off_kink(tag, got, want, kink, depth_as_sum=False):
    """Hold K2's outputs against its plain version: rays off the last-bin
    kink on every output (comp, w, acc 2e-2, depth 0.1), every ray on its
    weights before the last sample (2e-2), at most 5% of rays at the kink.
    ``depth_as_sum`` holds depth x acc = Σw·z at 2e-2 x FAR (6) in place of
    depth, as tests/test_torch_cuda.py does: a seeded model leaves rays
    nearly transparent, where depth = Σw·z / acc turns a weight difference
    far inside its tolerance into any depth difference (the plain depth
    difference is printed beside it). → the largest of those differences."""
    import numpy as np
    B, N = got[1].shape
    ok = ~kink
    errs = {n: max_diff(g[ok], w[ok]) for n, g, w in zip(NAMES, got, want)}
    depth_tol = 0.1
    if depth_as_sum:
        print(f"[{tag}] depth max|diff| off the kink {errs['depth']:.3g}, held as "
              f"sum w z instead (acc down to {float(want[2][ok].min()):.3g})",
              flush=True)
        errs["depth"] = max_diff((got[3] * got[2])[ok], (want[3] * want[2])[ok])
        depth_tol = 2e-2 * 6.0
    errs["w[:-1]"] = max_diff(got[1][:, :-1], want[1][:, :-1])
    n_kink = int(kink.sum())
    print(f"[{tag}] tile {B}x{N}: max|diff| vs plain {errs}; {n_kink} rays "
          f"at the last-bin kink, whole-tile comp max|diff| "
          f"{max_diff(got[0], want[0]):.3g}", flush=True)
    check(n_kink <= 0.05 * B, f"{tag}: {n_kink} of {B} rays at the kink")
    for n, tol in zip(NAMES + ("w[:-1]",), (2e-2, 2e-2, 2e-2, depth_tol, 2e-2)):
        check(np.isfinite(errs[n]) and errs[n] <= tol,
              f"{tag} {n} max |diff| {errs[n]} > {tol}")
    return max(errs.values())


def ipe_last_enc(ro, rd, rn, z, radii, pos_bands, contract=False):
    """Each ray's last sample encoded as its frustum Gaussian (K4's plain
    formulas), for ``last_bin_kink``."""
    from nerf_sandbox_tpu_torch.core.encoding import integrated_positional_encoding
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    mean, var = fr.ipe_gaussians(ro, rd, z * rn.reshape(-1, 1), radii.reshape(-1),
                                 contract)
    return integrated_positional_encoding(mean[:, -1], var[:, -1], pos_bands)


def blender_pose(i):
    """Orbit pose i at radius 4 (bench.py:44-51)."""
    import numpy as np
    th = i * np.pi / 6
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
    return c2w


def orbit_360_pose(i):
    """The Blender orbit pose scaled to radius 1, the mip-NeRF 360 "norm"
    frame of RESULTS.md (camera rig inside the contraction's unit ball)."""
    c2w = blender_pose(i)
    c2w[:3, 3] /= 4.0
    return c2w


def max_diff(a, b):
    return float((a - b).abs().max())


def ulp_ok(got, want):
    """Within one bf16 ulp: |got - want| <= 2^-7 max(1, |want|)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs().clamp(min=1.0)).all())


def kp_configs():
    """The 360 configuration at full width: (KPlanesConfig, NeRFConfig)."""
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    kcfg = KPlanesConfig((64, 128), 8, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
    return kcfg, NeRFConfig(kcfg.out_dim, 27, 8, 256, 4)


def phase_360_tile(torch, dev, card, packed_freq, kernels):
    """4b: K2c, K3 and K3t on one real fine tile of the 360 configuration,
    against their plain versions, timed. → context for phase 5b."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, scene_contract, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    kcfg, cfg = kp_configs()
    check(cfg.enc_pos_dim == 71, f"k-planes width {cfg.enc_pos_dim} != 71")
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(1),
                      grid_cfg=kcfg, device=dev)
    model_f = NeRFMLP(cfg, generator=torch.Generator().manual_seed(2),
                      grid_cfg=kcfg, device=dev)
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]],
                    np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(orbit_360_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    sl = slice(IMG * IMG // 2, IMG * IMG // 2 + EVAL_CHUNK)   # mid-frame tile
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn, vd = rays.d_march_norm[sl].contiguous(), rays.d_world_unit[sl].contiguous()
    enc_dir = positional_encoding(vd, dir_bands)
    mlp_c, mlp_f = fm.pack_nerf_params(model_c), fm.pack_nerf_params(model_f)
    grid_c = ke.pack_kplanes(model_c.pos_grid, kcfg)
    grid_f = ke.pack_kplanes(model_f.pos_grid, kcfg)
    ep = fm._enc_pads(cfg)[0]
    kw = dict(kp_cfg=kcfg, scene_contraction=True)
    with torch.no_grad():
        zc = stratified_samples(NEAR_360, FAR_360, 64, lindisp=True,
                                device=dev).expand(EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(mlp_c, ro, rd, zc, rn, enc_dir, None,
                                         kp_params=grid_c, **kw)
        z = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                   deterministic=True)).contiguous()
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    names = NAMES
    pts = scene_contract((ro[:, None, :] + rd[:, None, :] * (z * rn)[..., None])
                         .reshape(-1, 3))
    last = pts.reshape(B, N, 3)[:, -1]
    hold = hold_off_kink

    # K2 with K2c + K3, against its plain version
    got = fr.fused_raymarch(mlp_f, ro, rd, z, rn, enc_dir, None,
                            kp_params=grid_f, **kw)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp_f, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid_f))
    torch.cuda.synchronize()
    P = cfg.enc_pos_dim
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(mlp_f, ke.fused_kplanes_encode(grid_f, last, ep)[:, :P],
                            enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(mlp_f, ke.kplanes_encode_plain(grid_f, last, ep)[:, :P],
                                  enc_dir)[:, 3])])
    print(f"[K2c+K3] kink band |logit| < {bands[0]:.3g}", flush=True)
    kp_err = hold("K2c+K3", got, want, kink)

    # K3 on its own, on the same contracted points
    enc_k = ke.fused_kplanes_encode(grid_f, pts, ep)
    enc_p = ke.kplanes_encode_plain(grid_f, pts, ep)
    torch.cuda.synchronize()
    enc_err = max_diff(enc_k.float(), enc_p.float())
    n_off = int((enc_k != enc_p).sum())
    print(f"[K3] encode-only {pts.shape[0]} rows x {ep}: max|diff| {enc_err:.3g}, "
          f"{n_off} of {enc_k.numel()} values differ (bit for bit required)",
          flush=True)
    check(n_off == 0, f"K3 encode-only differs from its plain version in {n_off} values")
    check(not enc_k[:, P:].float().any(), "K3 padding columns are not zero")

    # K2c alone: the frequency model with contraction, on the same tile
    got_c = fr.fused_raymarch(packed_freq, ro, rd, z, rn, enc_dir, pos_bands,
                              scene_contraction=True)
    want_c = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_freq, ro, rd, z, dt, rn, enc_dir, pos_bands, contract=True))
    enc_last = positional_encoding(last, pos_bands)
    kink_c, _ = last_bin_kink([(
        fm.fused_nerf_apply(packed_freq, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(packed_freq, enc_last, enc_dir)[:, 3])])
    c_err = hold("K2c", got_c, want_c, kink_c)

    # K3t: a 4-D grid folded at t = 0.37, its time tables moved off their
    # neutral 1.0 to the spatial tables' N(1, 0.1)
    kcfg4 = kcfg._replace(time_res=8)
    model_t = NeRFMLP(cfg, generator=torch.Generator().manual_seed(3),
                      grid_cfg=kcfg4, device=dev)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for nm, tab in model_t.pos_grid.named_parameters():
            if nm == "line_t" or nm.split("_")[-1] in ("xt", "yt", "zt"):
                tab += 0.1 * torch.randn(tab.shape, generator=g).to(dev)
    mlp_t = fm.pack_nerf_params(model_t)
    grid_t = ke.pack_kplanes(model_t.pos_grid, kcfg4, t=0.37)
    got_t = fr.fused_raymarch(mlp_t, ro, rd, z, rn, enc_dir, None, kp_params=grid_t,
                              kp_cfg=kcfg4, scene_contraction=True,
                              infinite_last_bin=False)
    want_t = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp_t, ro, rd, z, fr._deltas(z, rn, False), rn, enc_dir, None,
        contract=True, kp=grid_t))
    enc_t_ok = ulp_ok(ke.fused_kplanes_encode(grid_t, pts, ep),
                      ke.kplanes_encode_plain(grid_t, pts, ep))
    torch.cuda.synchronize()
    # finite last bin: depth held as sum(w z) at the weight tolerance x z_far
    t_errs = {n: max_diff(g_, w_) for n, g_, w_ in zip(names[:3], got_t, want_t)}
    t_errs["sum_wz"] = max_diff(got_t[3] * got_t[2], want_t[3] * want_t[2])
    print(f"[K3t] 4-D fold (time_res 8, t 0.37), finite last bin: max|diff| "
          f"{t_errs}; encode-only within one bf16 ulp: {enc_t_ok}", flush=True)
    check(enc_t_ok, "K3t encode-only differs by more than one bf16 ulp")
    for n, tol in zip(("comp", "w", "acc", "sum_wz"), (2e-2, 2e-2, 2e-2, 2e-2 * FAR_360)):
        check(np.isfinite(t_errs[n]) and t_errs[n] <= tol,
              f"K3t {n} max |diff| {t_errs[n]} > {tol}")

    # times, bounds and the kernels' entries
    def k2(mlp, zz, **a):
        return lambda: fr.fused_raymarch(mlp, ro, rd, zz, rn, enc_dir, **a)

    # the coarse tile (its last sample is the fine tile's: same kink)
    dt_c = fr._deltas(zc, rn, True)
    got_co = fr.fused_raymarch(mlp_f, ro, rd, zc, rn, enc_dir, None, kp_params=grid_f,
                               **kw)
    want_co = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp_f, ro, rd, zc, dt_c, rn, enc_dir, None, contract=True, kp=grid_f))
    co_err = hold("K2c+K3 coarse", got_co, want_co, kink)

    kp_ms = cuda_ms(torch, k2(mlp_f, z, pos_bands=None, kp_params=grid_f, **kw))
    kp_coarse_ms = cuda_ms(torch, k2(mlp_f, zc, pos_bands=None, kp_params=grid_f, **kw))
    kp_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp_f, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid_f))
    co_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp_f, ro, rd, zc, dt_c, rn, enc_dir, None, contract=True, kp=grid_f), reps=3)
    tfold_ms = cuda_ms(torch, k2(mlp_t, z, pos_bands=None, kp_params=grid_t,
                                 kp_cfg=kcfg4, scene_contraction=True,
                                 infinite_last_bin=False))
    tfold_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp_t, ro, rd, z, fr._deltas(z, rn, False), rn, enc_dir, None,
        contract=True, kp=grid_t))
    freq_ms = cuda_ms(torch, k2(packed_freq, z, pos_bands=pos_bands))
    c_ms = cuda_ms(torch, k2(packed_freq, z, pos_bands=pos_bands,
                             scene_contraction=True))
    c_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_freq, ro, rd, z, dt, rn, enc_dir, pos_bands, contract=True))
    Q = B * N
    enc_ms, enc_ev_ms = k3_times(torch, ke, grid_f, pts, ep, "K3", card,
                                  profiled=True)
    enc_plain_ms = cuda_ms(torch, lambda: ke.kplanes_encode_plain(grid_f, pts, ep))

    def tile_bound(n):
        rows = B * n
        return bound(2.0 * mlp_macs_per_row(cfg) * rows,
                     B * (7 + 27) * 4 + rows * 4 * 3 + B * 5 * 4
                     + mlp_f.flat.numel() * 2 + grid_f.flat.numel() * 2,
                     (kplanes_fp32_flops(kcfg) + 20.0) * rows)

    kp_flops = kplanes_fp32_flops(kcfg) * Q
    b_kp, b_coarse = tile_bound(N), tile_bound(zc.shape[1])
    b_c = bound(2.0 * mlp_macs_per_row(packed_freq.cfg) * Q,
                B * (7 + 27) * 4 + Q * 4 * 3 + B * 5 * 4
                + packed_freq.flat.numel() * 2, 20.0 * Q)
    b_enc = bound(0.0, Q * 3 * 4 + Q * ep * 2 + grid_f.flat.numel() * 2, kp_flops)
    print(f"[K2c+K3] fine tile kernel {kp_ms:.3f} ms, plain {kp_plain_ms:.3f} ms, "
          f"bound {b_kp[0]:.3f} ms ({b_kp[1]}); coarse tile {B}x64 kernel "
          f"{kp_coarse_ms:.3f} ms, plain {co_plain_ms:.3f} ms, bound "
          f"{b_coarse[0]:.3f} ms ({b_coarse[1]}), "
          f"{100.0 * b_coarse[0] / kp_coarse_ms:.1f}%; K3t (4-D fold) "
          f"fine tile {tfold_ms:.3f} ms, {100.0 * b_kp[0] / tfold_ms:.1f}% of the "
          f"fine bound, plain {tfold_plain_ms:.3f} ms | {card}",
          flush=True)
    fetch_line("K2c+K3 fine", kp_ms, b_kp[0], mlp_passes(B, N), mlp_f, card)
    fetch_line("K2c+K3 coarse", kp_coarse_ms, b_coarse[0], mlp_passes(B, 64), mlp_f,
               card)
    print(f"[K2c] same tile, frequency model: with contraction {c_ms:.3f} ms, "
          f"without {freq_ms:.3f} ms, plain {c_plain_ms:.3f} ms, bound "
          f"{b_c[0]:.3f} ms ({b_c[1]})", flush=True)
    print(f"[K3] encode-only {Q} rows: kernel {enc_ms:.4f} ms (device; one call "
          f"{enc_ev_ms:.4f} ms), plain {enc_plain_ms:.3f} ms, bound {b_enc[0]:.4f} ms "
          f"({b_enc[1]}), {100.0 * b_enc[0] / enc_ms:.1f}% | {card}", flush=True)
    src = "nerf_sandbox_tpu_torch/csrc/"
    kernels["fused_raymarch_contract"] = dict(
        name="fused_raymarch_contract", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:406", max_abs_err=c_err,
        ms=c_ms, plain_ms=c_plain_ms, bound_ms=b_c[0], bound_by=b_c[1],
        library_ms=None)
    kernels["fused_raymarch_kplanes"] = dict(
        name="fused_raymarch_kplanes", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211",
        max_abs_err=max(kp_err, *(t_errs[n] for n in names[:3])), ms=kp_ms,
        plain_ms=kp_plain_ms,
        bound_ms=b_kp[0], bound_by=b_kp[1], library_ms=None)
    kernels["fused_raymarch_kplanes_coarse"] = dict(
        name="fused_raymarch_kplanes_coarse", route="cuda",
        source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=co_err,
        ms=kp_coarse_ms, plain_ms=co_plain_ms, bound_ms=b_coarse[0],
        bound_by=b_coarse[1], library_ms=None)
    kernels["kplanes_encode"] = dict(
        name="kplanes_encode", route="cuda", source=src + "kplanes_encode.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=enc_err,
        ms=enc_ms, plain_ms=enc_plain_ms, bound_ms=b_enc[0], bound_by=b_enc[1],
        library_ms=None)
    return dict(cfg=cfg, kcfg=kcfg, model_c=model_c, model_f=model_f, Kmat=Kmat,
                ro=ro, rd=rd, rn=rn, vd=vd, z=z, enc_dir=enc_dir, got=got,
                kink=kink, kp_ms=kp_ms, kp_coarse_ms=kp_coarse_ms, kcfg4=kcfg4,
                model_t=model_t)


def kp_frame_kink(torch, dev, model_c, model_f, kcfg, c2w, Kmat, H, W, far,
                  z_last=None):
    """The last sample of both passes of a contracted k-planes frame is at
    z = far: pixels whose sigma logit there is within the kernel-vs-plain
    band of 0 (``last_bin_kink``, K3 + K1 against the plain encode and MLP)
    are held by the frame PSNR. Under occupancy sampling the coarse slot is
    the grid (no model to hold) and each ray's last sample is at ``z_last``
    (H·W,) instead. → ((H, W) bool mask, the bands)."""
    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, scene_contract, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    _, dir_bands = vanilla_encoders()
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(c2w).to(dev),
        image_h=H, image_w=W, pixel_center=True)
    P = model_f.cfg.enc_pos_dim
    z = far if z_last is None else z_last.reshape(-1, 1)
    with torch.no_grad():
        pts = scene_contract(rays.o_march + rays.d_march_unit
                             * (z * rays.d_march_norm))
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        pairs = []
        for m in (model_c, model_f):
            if not hasattr(m, "pos_grid"):
                continue
            kp = ke.pack_kplanes(m.pos_grid, kcfg)
            pairs.append((
                fm.fused_nerf_apply(m, ke.fused_kplanes_encode(kp, pts, 128)[:, :P],
                                    enc_d)[:, 3],
                m(m.pos_grid(pts, compute_dtype=torch.bfloat16), enc_d,
                  compute_dtype=torch.bfloat16)[:, 3]))
        kink, bands = last_bin_kink(pairs)
    return kink.reshape(H, W).cpu().numpy(), bands


def phase_360_slice(torch, dev, card, ctx):
    """5b: two 800x800 frames of the 360 configuration through K2c + K3, and
    one k-planes ``nerf_forward_pass`` through K3 + K1, counted; frame 1
    against the plain path. → the kernels' launches on this path."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    cfg, kcfg, model_c, model_f = (ctx[k] for k in ("cfg", "kcfg", "model_c", "model_f"))
    Kmat = ctx["Kmat"]
    pos_bands, dir_bands = vanilla_encoders()
    hyper = EvalHyper(model=cfg, samp_near=NEAR_360, samp_far=FAR_360, lindisp=True,
                      scene_contraction=True, pos_encoder="kplanes", enc_cfg=kcfg,
                      use_kernel=True)
    tile_k = make_tile_renderer(hyper, None, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), None, dir_bands,
                                device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    ke.fused_kplanes_encode.launches = 0
    fm.fused_nerf_apply.launches = 0
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, orbit_360_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, ctx["ro"], ctx["rd"], ctx["z"],
                                pos_bands=pos_bands, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=ctx["rn"],
                                viewdirs_world_unit=ctx["vd"], infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                pos_encoder="kplanes", enc_cfg=kcfg,
                                scene_contraction=True, device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    tiles = dict(fr.fused_raymarch.tile_launches)
    n_c = hyper.nc_eval
    n_f = n_c + hyper.nf_eval
    launches = {"fused_raymarch_kplanes": tiles.get(("kplanes", n_f), 0),
                "fused_raymarch_kplanes_coarse": tiles.get(("kplanes", n_c), 0),
                "fused_raymarch_contract": routes["contract"],
                "kplanes_encode": ke.fused_kplanes_encode.launches,
                "fused_mlp": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    expect = n_tiles * N_POSES
    print(f"[slice 360] launches on this path: {launches}, K2 routes {routes}, "
          f"by (encoder, samples) {tiles} (k-planes + contraction expected "
          f"{expect} fine x {n_f} and {expect} coarse x {n_c}, {2 * n_tiles} a "
          f"frame)", flush=True)
    check(tiles == {("kplanes", n_f): expect, ("kplanes", n_c): expect}
          and routes["kplanes"] == routes["contract"] == 2 * expect,
          f"K2 k-planes/contraction launched {routes}, {tiles}, expected {expect} "
          f"fine and {expect} coarse")
    check(routes["freq"] == routes["tfold"] == routes["ipe"] == 0,
          f"the 360 path ran another K2 instantiation: {routes}")
    check(launches["kplanes_encode"] >= 1 and launches["fused_mlp"] >= 1,
          "K3's encode-only entry or K1 was not launched on the 360 path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"360 frame {k} {key} not finite")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"360 frame {k} rgb outside [0, 1]")
    ok = ~ctx["kink"]
    fwd_err = max_diff(fwd[0][ok], ctx["got"][0][ok])
    print(f"[slice 360] nerf_forward_pass(kplanes, use_kernel=True) vs K2 on the "
          f"tile, off the kink: comp max|diff| {fwd_err:.3g}", flush=True)
    check(fwd_err <= 2e-2, f"K3 + K1 forward vs K2 comp max |diff| {fwd_err}")

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, orbit_360_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    kink, bands = kp_frame_kink(torch, dev, model_c, model_f, kcfg, orbit_360_pose(1),
                                Kmat, IMG, IMG, FAR_360)
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k2_s = n_tiles * (ctx["kp_coarse_ms"] + ctx["kp_ms"]) / 1e3
    print(f"[slice 360] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice 360] K2 share of a frame: {n_tiles} x (coarse "
          f"{ctx['kp_coarse_ms']:.3f} + fine {ctx['kp_ms']:.3f} ms) = {k2_s:.3f} s "
          f"of {s_frame:.3f} s ({100 * k2_s / s_frame:.1f}%)", flush=True)
    print(f"[slice 360] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"360 frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"360 frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"360 frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")

    # one frame of the 4-D model at a fixed time: every K2 launch folds
    tile_t = make_tile_renderer(hyper._replace(enc_cfg=ctx["kcfg4"]), None,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    t0 = time.perf_counter()
    f4 = render_pose(tile_t, ctx["model_t"], ctx["model_t"], orbit_360_pose(1),
                     IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, time=0.37, device=dev)
    torch.cuda.synchronize()
    s4 = time.perf_counter() - t0
    routes4 = dict(fr.fused_raymarch.route_launches)
    print(f"[slice 360, 4-D] one frame at t = 0.37: {s4:.3f} s, K2 routes "
          f"{routes4} (fold expected {2 * n_tiles})", flush=True)
    check(routes4["tfold"] == routes4["kplanes"] == 2 * n_tiles,
          f"4-D frame: K2 routes {routes4}, expected {2 * n_tiles} folds")
    check(np.isfinite(f4["rgb"]).all() and f4["rgb"].min() >= 0.0
          and f4["rgb"].max() <= 1.0, "4-D frame rgb not finite or outside [0, 1]")
    return launches


def ipe_fp32_flops():
    """fp32 operations K4 adds per sample: the interval and moments (~40),
    the lift or the contraction pushforward (~110), and per sin/cos column
    of the L = 10 encode the attenuation's multiplies and exp (60 x 3)."""
    return 150 + 60 * 3


def phase_ipe_tile(torch, dev, card, packed_f, packed_d, t4, ctx360, kernels):
    """4c: K4 on phase 4's Blender fine tile and, with contraction, on phase
    4b's 360 tile, against its plain version; ERT; timed beside the
    frequency tile. → context for phase 5c."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        pixel_cone_radii, vanilla_encoders)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr

    def k1_and_plain(enc, enc_d):
        return (fm.fused_nerf_apply(packed_f, enc, enc_d)[:, 3],
                fm.fused_nerf_apply_plain(packed_f, enc, enc_d)[:, 3])

    pos_bands, _ = vanilla_encoders()
    ro, rd, rn, z, zc, enc_dir = (t4[k] for k in ("ro", "rd", "rn", "z", "zc",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    fx = torch.tensor(FOCAL, dtype=torch.float32, device=dev)
    radii = pixel_cone_radii(fx, rn.reshape(-1))
    print(f"[K4] pixel-cone radii {float(radii.min()):.3g}..{float(radii.max()):.3g}",
          flush=True)

    got = fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir, pos_bands,
                            ipe_radii=radii)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, radii=radii))
    torch.cuda.synchronize()
    kink, bands = last_bin_kink([k1_and_plain(
        ipe_last_enc(ro, rd, rn, z, radii, pos_bands), enc_dir)])
    print(f"[K4] kink band |logit| < {bands[0]:.3g}", flush=True)
    k4_err = hold_off_kink("K4", got, want, kink)

    # ERT on the IPE tile, and on the dense model where whole blocks stop
    for tag, pk in (("golden", packed_f), ("dense", packed_d)):
        full = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                 ipe_radii=radii)
        ert = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                ipe_radii=radii, ert_eps=1e-4)
        ert_errs = {n: max_diff(g, w) for n, g, w in zip(NAMES, ert, full)}
        print(f"[K4] ERT(1e-4) vs none, {tag} model: max|diff| {ert_errs}; "
              f"{float((ert[1] == 0).float().mean()):.3f} of the weights skipped",
              flush=True)
        for n in NAMES:
            check(np.isfinite(ert_errs[n]) and ert_errs[n] <= 1e-3,
                  f"K4 ERT ({tag}) {n} max |diff| {ert_errs[n]} > 1e-3")

    # K4 with contraction, on the 360 tile (lindisp 0.125..22.5, radius-1 orbit)
    c_ro, c_rd, c_rn, c_z, c_ed = (ctx360[k] for k in ("ro", "rd", "rn", "z",
                                                       "enc_dir"))
    c_radii = pixel_cone_radii(fx, c_rn.reshape(-1))
    got_c = fr.fused_raymarch(packed_f, c_ro, c_rd, c_z, c_rn, c_ed, pos_bands,
                              ipe_radii=c_radii, scene_contraction=True)
    c_dt = fr._deltas(c_z, c_rn, True)
    want_c = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, c_ro, c_rd, c_z, c_dt, c_rn, c_ed, pos_bands, contract=True,
        radii=c_radii))
    torch.cuda.synchronize()
    kink_c, bands_c = last_bin_kink([k1_and_plain(
        ipe_last_enc(c_ro, c_rd, c_rn, c_z, c_radii, pos_bands, contract=True),
        c_ed)])
    print(f"[K4c] kink band |logit| < {bands_c[0]:.3g}", flush=True)
    k4c_err = hold_off_kink("K4c", got_c, want_c, kink_c)

    # times, the frequency tile between them on the same inputs
    def k2(**a):
        return lambda: fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir,
                                         pos_bands, **a)

    freq_ms = cuda_ms(torch, k2())
    ipe_ms = cuda_ms(torch, k2(ipe_radii=radii))
    ipe_coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, ro, rd, zc, rn, enc_dir, pos_bands, ipe_radii=radii))
    ipe_ert_ms = cuda_ms(torch, k2(ipe_radii=radii, ert_eps=1e-4))
    ipe_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, radii=radii))
    ipe_c_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, c_ro, c_rd, c_z, c_rn, c_ed, pos_bands, ipe_radii=c_radii,
        scene_contraction=True))
    ipe_c_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, c_ro, c_rd, c_z, c_dt, c_rn, c_ed, pos_bands, contract=True,
        radii=c_radii))
    freq_ms2 = cuda_ms(torch, k2())
    Q = B * N
    b_ipe = bound(2.0 * mlp_macs_per_row(packed_f.cfg) * Q,
                  B * (8 + 27) * 4 + Q * 4 * 3 + B * 5 * 4
                  + packed_f.flat.numel() * 2, ipe_fp32_flops() * Q)
    print(f"[K4] fine tile {B}x{N}: IPE kernel {ipe_ms:.3f} ms, frequency "
          f"kernel on the same tile {freq_ms:.3f} / {freq_ms2:.3f} ms (before / "
          f"after), IPE with ERT(1e-4) {ipe_ert_ms:.3f} ms, plain "
          f"{ipe_plain_ms:.3f} ms, bound {b_ipe[0]:.3f} ms ({b_ipe[1]}); coarse "
          f"tile {B}x{zc.shape[1]} IPE kernel {ipe_coarse_ms:.3f} ms | {card}",
          flush=True)
    fetch_line("K4 fine", ipe_ms, b_ipe[0], mlp_passes(B, N), packed_f, card)
    fetch_line("K4 coarse", ipe_coarse_ms, bound(2.0 * mlp_macs_per_row(packed_f.cfg)
                                                 * B * zc.shape[1], 0.0)[0],
               mlp_passes(B, zc.shape[1]), packed_f, card)
    print(f"[K4c] 360 fine tile with contraction: kernel {ipe_c_ms:.3f} ms, "
          f"plain {ipe_c_plain_ms:.3f} ms", flush=True)
    kernels["fused_raymarch_ipe"] = dict(
        name="fused_raymarch_ipe", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:432",
        max_abs_err=max(k4_err, k4c_err), ms=ipe_ms, plain_ms=ipe_plain_ms,
        bound_ms=b_ipe[0], bound_by=b_ipe[1], library_ms=None)
    return dict(radii=radii, got=got, kink=kink, ipe_ms=ipe_ms,
                ipe_coarse_ms=ipe_coarse_ms)


def phase_ipe_slice(torch, dev, card, model_c, model_f, t4, ctx):
    """5c: two 800x800 IPE frames through K4 and one IPE ``nerf_forward_pass``
    through K1, counted; frame 1 against the plain path. → the kernels'
    launches on this path."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        pixel_cone_radii, positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    pos_bands, dir_bands = vanilla_encoders()
    Kmat = t4["Kmat"]
    hyper = EvalHyper(model=model_f.cfg, ipe=True, use_kernel=True)
    tile_k = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = 0
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, blender_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, t4["ro"], t4["rd"], t4["z"],
                                pos_bands=pos_bands, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=t4["rn"],
                                viewdirs_world_unit=t4["vd"], infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                ipe=True, radii=ctx["radii"], device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_ipe": routes["ipe"],
                "fused_mlp": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    expect = 2 * n_tiles * N_POSES
    print(f"[slice IPE] launches on this path: {launches}, K2 routes {routes} "
          f"(IPE expected {expect}, {2 * n_tiles} a frame)", flush=True)
    check(fr.fused_raymarch.launches == routes["ipe"] == expect,
          f"K2 launched {fr.fused_raymarch.launches} times ({routes}), expected "
          f"{expect} IPE launches")
    check(routes["freq"] == routes["kplanes"] == routes["contract"] == 0,
          f"the IPE path ran another K2 instantiation: {routes}")
    check(launches["fused_mlp"] >= 1, "K1 was not launched on the IPE path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"IPE frame {k} {key} not finite")
        check(f["rgb"].shape == (IMG, IMG, 3), f"IPE frame {k} rgb shape")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"IPE frame {k} rgb outside [0, 1]")
    ok = ~ctx["kink"]
    fwd_err = max_diff(fwd[0][ok], ctx["got"][0][ok])
    print(f"[slice IPE] nerf_forward_pass(ipe, use_kernel=True) vs K4 on the "
          f"tile, off the kink: comp max|diff| {fwd_err:.3g}", flush=True)
    check(fwd_err <= 2e-2, f"IPE forward vs K4 comp max |diff| {fwd_err}")

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, blender_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the kink band on each pass's last sample, whose Gaussian depends on its
    # interval: the coarse z, and the fine z the plain path's coarse pass gives
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(blender_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    radii = pixel_cone_radii(torch.tensor(Kmat[0, 0], device=dev),
                             rays.d_world_norm[..., 0])
    packed = [fm.pack_nerf_params(m) for m in (model_c, model_f)]
    pairs = [([], []), ([], [])]
    with torch.no_grad():
        for i in range(0, IMG * IMG, EVAL_CHUNK):
            sl = slice(i, i + EVAL_CHUNK)
            ro, rd, rn = rays.o_march[sl], rays.d_march_unit[sl], rays.d_march_norm[sl]
            vd, ra = rays.d_world_unit[sl], radii[sl]
            enc_d = positional_encoding(vd, dir_bands)
            zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(ro.shape[0], 64)
            _, w_c, _, _ = nerf_forward_pass(
                model_c, ro, rd, zc, pos_bands=pos_bands, dir_bands=dir_bands,
                white_bkgd=True, ray_norms=rn, viewdirs_world_unit=vd,
                infinite_last_bin=True, compute_dtype=torch.bfloat16, ipe=True,
                radii=ra, device=dev)
            zf = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                        deterministic=True))
            for j, (m, pk, zz) in enumerate(((model_c, packed[0], zc),
                                             (model_f, packed[1], zf))):
                enc = ipe_last_enc(ro, rd, rn, zz, ra, pos_bands)
                pairs[j][0].append(fm.fused_nerf_apply(pk, enc, enc_d)[:, 3])
                pairs[j][1].append(m(enc, enc_d, compute_dtype=torch.bfloat16)[:, 3])
        kink, bands = last_bin_kink([(torch.cat(k), torch.cat(p)) for k, p in pairs])
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k4_s = n_tiles * (ctx["ipe_coarse_ms"] + ctx["ipe_ms"]) / 1e3
    print(f"[slice IPE] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice IPE] K4 share of a frame: {n_tiles} x (coarse "
          f"{ctx['ipe_coarse_ms']:.3f} + fine {ctx['ipe_ms']:.3f} ms) = {k4_s:.3f} s "
          f"of {s_frame:.3f} s ({100 * k4_s / s_frame:.1f}%)", flush=True)
    print(f"[slice IPE] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"IPE frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"IPE frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"IPE frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")
    return launches


def k1_widths(torch, dev, card, widths, kernels, route, reps=10):
    """K1 at 2^20 rows of an 8xH skip-4 MLP with seeded weights for each H
    of ``widths``, against its plain version (phase 3's 0.05), timed with its
    bound; each width's kernels-line row (``fused_mlp_h{H}``). → {H: model}."""
    import numpy as np

    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    rng = np.random.RandomState(widths[0] % 7)
    Q = EVAL_CHUNK * 64
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    models = {}
    for H in widths:
        cfg = NeRFConfig(63, 27, 8, H, 4)
        m = NeRFMLP(cfg, generator=torch.Generator().manual_seed(H), device=dev)
        pk = fm.pack_nerf_params(m)
        got = fm.fused_nerf_apply(pk, ep, ed)
        want = fm.fused_nerf_apply_plain(pk, ep, ed)
        torch.cuda.synchronize()
        err = max_diff(got, want)
        check(torch.isfinite(got).all().item(), f"K1 8x{H} output not finite")
        check(err <= 0.05, f"K1 8x{H} max |diff| {err} > 0.05")
        ms = cuda_ms(torch, lambda: fm.fused_nerf_apply(pk, ep, ed), reps=reps)
        plain_ms = cuda_ms(torch, lambda: fm.fused_nerf_apply_plain(pk, ep, ed), reps=3)
        b_ms, b_by = bound(2.0 * mlp_macs_per_row(cfg) * Q,
                           Q * (63 + 27) * 2 + pk.flat.numel() * 2 + Q * 4 * 4)
        print(f"[K1 8x{H} {route}] Q={Q} max|diff|={err:.3g} (tol 0.05) kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{2.0 * mlp_macs_per_row(cfg) / 1e6:.3f} MFLOP a row; "
              f"{100.0 * b_ms / ms:.1f}% of the bound) | {card}", flush=True)
        fetch_line(f"K1 8x{H} {route}", ms, b_ms, -(-Q // fm.TILE_M), pk, card)
        if H > 256:
            ep_pad, ed_pad = fm.pad_cols_bf16(ep, 64), fm.pad_cols_bf16(ed, 32)
            chain_ms = cuda_ms(torch, lambda: mlp_chain_bf16(torch, pk, ep_pad, ed_pad),
                               reps=reps)
            print(f"[K1 8x{H} {route}] yardstick, not used by the port: the bf16 "
                  f"cuBLAS chain (phase 3's) {chain_ms:.3f} ms at Q={Q}; K1 {ms:.3f} ms "
                  f"= {chain_ms / ms:.2f}x the chain's speed | {card}", flush=True)
            del ep_pad, ed_pad
        kernels[f"fused_mlp_h{H}"] = dict(
            name=f"fused_mlp_h{H}", route="cuda",
            source="nerf_sandbox_tpu_torch/csrc/fused_mlp.cu",
            replaces="nerf_sandbox_tpu/ops/fused_mlp.py:162", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        models[H] = m
    return models


def k2_fine_tile(torch, card, t4, m, kernels, route, reps=10, depth_as_sum=False):
    """K2 through model ``m`` on phase 4's Blender fine tile on the
    frequency route, against its plain version off the last-bin kink (phase
    4's tolerances; ``hold_off_kink``'s ``depth_as_sum``), timed with its
    bound beside the coarse tile; the kernels-line row
    ``fused_raymarch_h{H}``. → (K2's outputs, kink mask)."""
    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr

    pos_bands, _ = vanilla_encoders()
    H = m.cfg.hidden_dim
    tag = f"K2 8x{H} {route}"
    pk = fm.pack_nerf_params(m)
    ro, rd, rn, z, zc, enc_dir = (t4[k] for k in ("ro", "rd", "rn", "z", "zc",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    got = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        pk, ro, rd, z, dt, rn, enc_dir, pos_bands))
    torch.cuda.synchronize()
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(pk, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(pk, enc_last, enc_dir)[:, 3])])
    print(f"[{tag}] kink band |logit| < {bands[0]:.3g}", flush=True)
    k2_err = hold_off_kink(tag, got, want, kink, depth_as_sum)
    ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                  pos_bands), reps=reps)
    coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, zc, rn, enc_dir,
                                                         pos_bands), reps=reps)
    plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        pk, ro, rd, z, dt, rn, enc_dir, pos_bands), reps=3)
    macs = mlp_macs_per_row(m.cfg)
    b_ms, b_by = bound(2.0 * macs * B * N, B * (7 + 27) * 4 + B * N * 4 * 3
                       + B * 5 * 4 + pk.flat.numel() * 2)
    b_coarse = bound(2.0 * macs * B * zc.shape[1], 0.0)[0]
    print(f"[{tag}] fine tile {B}x{N} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}; {100.0 * b_ms / ms:.1f}% of the bound); "
          f"coarse tile {B}x{zc.shape[1]} kernel {coarse_ms:.3f} ms | {card}",
          flush=True)
    fetch_line(f"{tag} fine", ms, b_ms, mlp_passes(B, N), pk, card)
    fetch_line(f"{tag} coarse", coarse_ms, b_coarse, mlp_passes(B, zc.shape[1]), pk,
               card)
    kernels[f"fused_raymarch_h{H}"] = dict(
        name=f"fused_raymarch_h{H}", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559", max_abs_err=k2_err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return got, kink


def phase_wide(torch, dev, card, t4, kernels):
    """3w, 4w, 5w: hidden widths 384 and 512, the wide instantiations of K1
    and K2 (activations in shared memory, layers in output chunks of 256
    columns). K1 at 2^20 rows of an 8xH skip-4 MLP with seeded weights, and
    one 8x512 and one 8x384 Blender fine tile (phase 4's) on the frequency
    route, against their plain versions, timed with their bounds; then one
    800x800 Blender frame of the 8x512 model through ``render_pose``, the
    8x384 model through ``render_rays_chunked`` on the tile's rays and each
    width's ``nerf_forward_pass(use_kernel=True)`` through K1, counted. →
    launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose, render_rays_chunked)

    pos_bands, dir_bands = vanilla_encoders()
    models = k1_widths(torch, dev, card, (384, 512), kernels, "wide")
    m = models[512]
    got, kink = k2_fine_tile(torch, card, t4, m, kernels, "wide")
    k2_fine_tile(torch, card, t4, models[384], kernels, "wide")
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))

    # 5w: the wide slice, counted
    tile_k = make_tile_renderer(EvalHyper(model=m.cfg, use_kernel=True), pos_bands,
                                dir_bands, device=dev)
    fwd_kw = dict(pos_bands=pos_bands, dir_bands=dir_bands, white_bkgd=True,
                  ray_norms=rn, viewdirs_world_unit=vd, infinite_last_bin=True,
                  compute_dtype=torch.bfloat16, use_kernel=True, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    frame = render_pose(tile_k, m, m, blender_pose(1), IMG, IMG, t4["Kmat"],
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with torch.no_grad():
        fwd = nerf_forward_pass(m, ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_h512": routes["freq"],
                "fused_mlp_h512": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    check(fr.fused_raymarch.launches == routes["freq"] == 2 * n_tiles,
          f"the 8x512 frame launched K2 {fr.fused_raymarch.launches} times ({routes}), "
          f"expected {2 * n_tiles} frequency launches")
    check(launches["fused_mlp_h512"] >= 1, "K1 8x512 was not launched")
    for key in ("rgb", "acc", "depth"):
        check(np.isfinite(frame[key]).all(), f"8x512 frame {key} not finite")
    check(frame["rgb"].min() >= 0.0 and frame["rgb"].max() <= 1.0,
          "8x512 frame rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K1 8x512 forward vs K2 comp max |diff| {fwd_err}")
    fm.fused_nerf_apply.launches = 0
    with torch.no_grad():
        fwd3 = nerf_forward_pass(models[384], ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    launches["fused_mlp_h384"] = fm.fused_nerf_apply.launches
    check(launches["fused_mlp_h384"] >= 1 and bool(torch.isfinite(fwd3[0]).all()),
          "K1 8x384 was not launched or gave non-finite colours")
    fr.reset_launches()
    tile_3 = make_tile_renderer(EvalHyper(model=models[384].cfg, use_kernel=True),
                                pos_bands, dir_bands, device=dev)
    out3 = render_rays_chunked(tile_3, models[384], models[384], ro, rd, rn, vd,
                               eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    launches["fused_raymarch_h384"] = fr.fused_raymarch.route_launches["freq"]
    check(fr.fused_raymarch.launches == launches["fused_raymarch_h384"] == 2,
          f"the 8x384 tile launched K2 {fr.fused_raymarch.launches} times "
          f"({dict(fr.fused_raymarch.route_launches)}), expected 2 frequency launches")
    for key in ("rgb", "acc", "depth"):
        check(bool(torch.isfinite(out3[key]).all()), f"8x384 render {key} not finite")
    check(float(out3["rgb"].min()) >= 0.0 and float(out3["rgb"].max()) <= 1.0,
          "8x384 render rgb outside [0, 1]")
    print(f"[slice 8x512] one {IMG}x{IMG} frame {secs:.3f} s, launches {launches}, "
          f"K2 routes {routes}; nerf_forward_pass vs K2 on the tile, off the kink: "
          f"comp max|diff| {fwd_err:.3g} | {card}", flush=True)
    return launches


def phase_large(torch, dev, card, t4, kernels):
    """3x, 4x, 5x: hidden widths above 512, the large route of K1 and K2
    (activations in global scratch, one instantiation for every width). K1 at
    2^20 rows of 8x640 and 8x1024 skip-4 MLPs with seeded weights, and one
    8x1024 Blender fine tile (phase 4's) on the frequency route, against their
    plain versions (phase 3's and 4's tolerances), timed with their bounds;
    then, counted, the 8x1024 model through ``render_rays_chunked`` on phase
    4's 16384 rays (a coarse and a fine K2 launch) and each width's
    ``nerf_forward_pass(use_kernel=True)`` (K1). → launches."""
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_rays_chunked)

    pos_bands, dir_bands = vanilla_encoders()
    models = k1_widths(torch, dev, card, (640, 1024), kernels, "large", reps=5)
    m = models[1024]
    got, kink = k2_fine_tile(torch, card, t4, m, kernels, "large", reps=5,
                             depth_as_sum=True)
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))
    B = z.shape[0]

    # 5x: the large route on the renderer's and the forward pass's paths,
    # counted
    tile_k = make_tile_renderer(EvalHyper(model=m.cfg, use_kernel=True), pos_bands,
                                dir_bands, device=dev)
    fwd_kw = dict(pos_bands=pos_bands, dir_bands=dir_bands, white_bkgd=True,
                  ray_norms=rn, viewdirs_world_unit=vd, infinite_last_bin=True,
                  compute_dtype=torch.bfloat16, use_kernel=True, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = fm.fused_nerf_apply.large_launches = 0
    t0 = time.perf_counter()
    out = render_rays_chunked(tile_k, m, m, ro, rd, rn, vd, eval_chunk=EVAL_CHUNK,
                              device=dev)
    with torch.no_grad():
        fwd = nerf_forward_pass(m, ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_h1024": routes["large"],
                "fused_mlp_h1024": fm.fused_nerf_apply.large_launches}
    check(fr.fused_raymarch.launches == routes["freq"] == routes["large"] == 2,
          f"the 8x1024 tile launched K2 {fr.fused_raymarch.launches} times ({routes}), "
          f"expected 2 frequency launches on the large route")
    check(launches["fused_mlp_h1024"] == fm.fused_nerf_apply.launches == 1,
          "K1 8x1024 was not launched once on the large route")
    for key in ("rgb", "acc", "depth"):
        check(bool(torch.isfinite(out[key]).all()), f"8x1024 render {key} not finite")
    check(float(out["rgb"].min()) >= 0.0 and float(out["rgb"].max()) <= 1.0,
          "8x1024 render rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K1 8x1024 forward vs K2 comp max |diff| {fwd_err}")
    fm.fused_nerf_apply.launches = fm.fused_nerf_apply.large_launches = 0
    with torch.no_grad():
        fwd6 = nerf_forward_pass(models[640], ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    launches["fused_mlp_h640"] = fm.fused_nerf_apply.large_launches
    check(launches["fused_mlp_h640"] == 1 and bool(torch.isfinite(fwd6[0]).all()),
          "K1 8x640 was not launched on the large route or gave non-finite colours")
    print(f"[slice 8x1024 large] render_rays_chunked of {B} rays and a forward pass "
          f"{secs:.3f} s, launches {launches}, K2 routes {routes}; nerf_forward_pass "
          f"vs K2 on the tile, off the kink: comp max|diff| {fwd_err:.3g} | {card}",
          flush=True)
    return launches


def bench_frames():
    """``bench.py``'s synthetic scene as arrays: 4 frames of 800x800 RGBA
    noise (uint8), focal 1111.1, cameras on a circle of radius 4 looking at
    the origin (bench.py:40-52) → (images, K, c2ws)."""
    import numpy as np

    rng = np.random.RandomState(0)
    K = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]], np.float32)
    images, c2ws = [], []
    for i in range(4):
        th = i * np.pi / 6
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                [-np.sin(th), 0, np.cos(th)]], np.float32)
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
        images.append(rng.randint(0, 255, (IMG, IMG, 4), np.uint8))
        c2ws.append(c2w)
    return images, K, c2ws


def bench_scene(torch, dev):
    """``bench.py``'s synthetic scene, on the card (``SceneArrays``)."""
    from nerf_sandbox_tpu_torch.data.sampler import SceneArrays
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    images, K, c2ws = bench_frames()
    frames = [Frame(image=img, K=K, c2w=c2w) for img, c2w in zip(images, c2ws)]
    return SceneArrays.from_scene(Scene(frames=frames, white_bkgd=True), device=dev)


TRAIN_RAYS, TRAIN_WARMUP, TRAIN_STEPS = 1024, 10, 50


def phase_train(torch, dev, card, figures):
    """8: the training step (``train/step.py``) on ``bench.py``'s recipe: the
    synthetic scene, 1024 rays, 8x256 skip-4, 64 + 128 samples, sigma noise
    1.0, relu, white background, infinite last bin, near 2 / far 6, bf16
    MLP, Adam 5e-4 with cosine T_max 50000 / eta_min 5e-6. Ten warm-up
    steps, then TRAIN_STEPS timed ones: ms/step, train ray-samples/s by
    bench.py's formula (rays x (64 + 192) / s), the peak memory. Every loss
    finite, every tensor of the state on the card, no kernel launched (the
    counters read 0: the JAX train step runs none either); five more steps
    under ``torch.profiler`` (device time by kernel, idle share). Then one step from
    the same state and draws on the card and on the CPU: loss and PSNR at
    rtol 1e-2; all gradients together within 5e-2 of their norm, each
    array within 0.3 of its norm and at a cosine >= 0.95 with the CPU's.
    Those are bounds on two correct bf16 evaluations of one function: the
    JAX step jitted and run op by op differ on the CPU by 1.3% together,
    14.8% in one array, cosine 0.989 (tests/test_torch_train_step.py's
    vanilla case), since bf16 products round where the two accumulate in
    another order and a fine sample moved by the coarse weights' last bits
    moves single entries."""
    import copy

    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec, SceneArrays
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.ops import precision_probe as pp
    from nerf_sandbox_tpu_torch.train import step as ts

    scene = bench_scene(torch, dev)
    nc, nf = 64, 128
    hyper = ts.TrainHyper(model=NeRFConfig(63, 27, 8, 256, 4), nc=nc, nf=nf,
                          raw_noise_std=1.0, sigma_activation="relu", white_bkgd=True,
                          infinite_last_bin=True, samp_near=2.0, samp_far=6.0)
    spec = RayBatchSpec(rays_per_batch=TRAIN_RAYS, image_h=IMG, image_w=IMG,
                        white_bkgd=True)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 50_000, "eta_min": 5e-6})
    state = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                                generator=torch.Generator().manual_seed(0), device=dev)
    pos_b, dir_b = vanilla_encoders()
    step = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, device=dev)

    counters = (fm.fused_nerf_apply, fr.fused_raymarch, ke.fused_kplanes_encode,
                pp.precision_dot)
    for c in counters:
        c.launches = 0
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, scene)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, scene)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {c.__name__: c.launches for c in counters}
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), f"non-finite training losses {losses}")
    check(not any(launched.values()),
          f"the train step launched hand-written kernels: {launched}")
    tensors = ([state.step] + list(ts.named_params(state).values())
               + [t for g in state.opt_state.values() for t in g.values()])
    check(all(t.device.type == "cuda" for t in tensors),
          "a tensor of the train state is not on the card")
    check(int(state.step) == TRAIN_WARMUP + TRAIN_STEPS, f"step {int(state.step)}")
    ms = 1e3 * secs / TRAIN_STEPS
    rate = TRAIN_RAYS * (nc + (nc + nf)) / (secs / TRAIN_STEPS)
    print(f"[train] bench.py recipe ({TRAIN_RAYS} rays, 8x256, 64+128, bf16): "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, {ms:.3f} ms/step, "
          f"{rate:.1f} train ray-samples/s (rays x (64+192) / s), peak memory "
          f"{peak:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; kernel "
          f"launches {launched} | {card}", flush=True)

    def five_steps():
        nonlocal state
        for _ in range(5):
            state, _ = step(state, scene)
    profile_frame(torch, five_steps, "train profile, 5 steps", card)

    # one step from the same state and draws, on the card and on the CPU
    g = torch.Generator(device=dev).manual_seed(7)
    draws = ts.make_draws(hyper, spec, scene, state.step + 1, g)
    cpu = torch.device("cpu")
    state_cpu = ts.TrainState(state.step.cpu(), copy.deepcopy(state.model_c).to(cpu),
                              copy.deepcopy(state.model_f).to(cpu),
                              {k: {n: t.cpu() for n, t in v.items()}
                               for k, v in state.opt_state.items()}, state.host_step)
    scene_cpu = SceneArrays(*(t.cpu() for t in scene))
    step_cpu = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, device="cpu")
    l_gpu, mse_gpu, g_gpu, _ = step.loss_and_grads(state, scene, draws=draws)
    l_cpu, mse_cpu, g_cpu, _ = step_cpu.loss_and_grads(
        state_cpu, scene_cpu, draws={k: v.cpu() for k, v in draws.items()})
    psnr = [float(ts.mse2psnr(x)) for x in (mse_gpu, mse_cpu)]
    d_loss = abs(float(l_gpu) / float(l_cpu) - 1.0)
    d_psnr = abs(psnr[0] / psnr[1] - 1.0)
    norm = torch.linalg.vector_norm
    g_gpu = {k: v.cpu() for k, v in g_gpu.items()}
    per = {k: float(norm(g_gpu[k] - g_cpu[k]) / max(float(norm(g_cpu[k])), 1e-30))
           for k in g_cpu}
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g_gpu[k].reshape(1, -1), g_cpu[k].reshape(1, -1))) for k in g_cpu}
    flat = [torch.cat([g[k].reshape(-1) for k in sorted(g_cpu)]) for g in (g_gpu, g_cpu)]
    d_all = float(norm(flat[0] - flat[1]) / norm(flat[1]))
    worst = max(per, key=per.get)
    print(f"[train] one step, card vs CPU from the same state and draws: loss "
          f"{float(l_gpu):.6f} vs {float(l_cpu):.6f} (rel {d_loss:.3g}, tol 1e-2), "
          f"PSNR {psnr[0]:.4f} vs {psnr[1]:.4f} dB (rel {d_psnr:.3g}, tol 1e-2); "
          f"gradients: all together {d_all:.3g} of their norm (tol 5e-2), the "
          f"farthest array {worst} {per[worst]:.3g} of its norm (tol 0.3), lowest "
          f"cosine {min(cos.values()):.5f} (min 0.95) | {card}", flush=True)
    check(d_loss <= 1e-2 and d_psnr <= 1e-2, "card vs CPU loss / PSNR differ")
    check(d_all <= 5e-2 and per[worst] <= 0.3 and min(cos.values()) >= 0.95,
          f"card vs CPU gradients differ: {d_all:.3g} together, {per[worst]:.3g} "
          f"in {worst}, cosine {min(cos.values()):.5f}")
    phase_train_chunk(torch, dev, card, hyper, spec, tx, state, scene,
                      {"ms": ms, "rate": rate, "peak": peak}, figures)
    figures["train_ms"] = ms
    return ms


TRAIN_SCAN, TRAIN_CHUNKS = 16, 4


def _bits_apart(a, b):
    """(every pair bit-equal, the largest |a - b| over the pairs)."""
    import torch
    worst, equal = 0.0, True
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            equal = False
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return equal, worst


def phase_train_chunk(torch, dev, card, hyper, spec, tx, state, scene, eager, figures):
    """8, the chunk: ``build_train_step(scan_steps=16)`` on phase 8's recipe
    and state, on the card one CUDA graph of 16 steps. Two eager runs of 16
    single steps from copies of one state must agree bit for bit (or their
    spread is printed); then the captured chunk from a third copy against
    them: every tensor of the state (the step, parameters, moments, counts)
    and the metrics (``loss``, ``psnr``, ``mse_f``, ``finite`` and the
    16 losses' mean), bit-equal or within the eager spread. Timed: ms per
    optimizer step over 4 chunks after warm-up, train ray-samples/s, peak
    memory, and one chunk under ``torch.profiler``, beside phase 8's eager
    figures. Then the 360 k-planes recipe (planes (64, 128) x 8, TV 1e-4)
    with one texel poisoned to inf, through its own captured chunk: the TV
    makes every loss infinite, so ``skipped`` must be 16, every tensor held
    and the step advanced by 16."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.train import step as ts

    k = TRAIN_SCAN
    pos_b, dir_b = vanilla_encoders()
    chunk = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, scan_steps=k, device=dev)
    keys = ("loss", "psnr", "mse_f", "finite", "loss_mean")

    def eager_run(st):
        losses = []
        for _ in range(k):
            st, m = chunk.step(st, scene)
            losses.append(m["loss"])
        m = dict(m, loss_mean=(torch.stack(losses[:-1]).sum() + losses[-1]) / k)
        return st, m

    def flat(st, m):
        return ts.state_tensors(st) + [m[n] for n in keys]

    base = ts.clone_state(state)
    a, ma = eager_run(ts.clone_state(base))
    b, mb = eager_run(ts.clone_state(base))
    eq_ee, d_ee = _bits_apart(flat(a, ma), flat(b, mb))
    g = ts.clone_state(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g, mg = chunk(g, scene)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # the graph's intermediates live in its pool, allocated while it was
    # captured: the peak of the first call is the chunk's footprint
    peak = torch.cuda.max_memory_allocated() / 2**30
    mg = {n: t.clone() for n, t in mg.items()}
    eq_ge, d_ge = _bits_apart(flat(a, ma), flat(g, mg))
    print(f"[train chunk] {k} eager steps twice from one state: "
          f"{'bit-equal' if eq_ee else f'spread max|diff| {d_ee:.3g}'}; the "
          f"captured {k}-step chunk against them: "
          f"{'bit-equal' if eq_ge else f'max|diff| {d_ge:.3g}'} (step, parameters, "
          f"moments, counts, loss, psnr, mse_f, finite, loss_mean); first call "
          f"(warm-up step, capture, replay) {first_s:.3f} s", flush=True)
    check(chunk.captures == 1, f"the chunk captured {chunk.captures} graphs")
    check(eq_ge or (not eq_ee and d_ge <= d_ee),
          f"the captured chunk differs from {k} eager steps by {d_ge:.3g} "
          f"(eager spread {d_ee:.3g})")
    check(g.host_step == base.host_step + k and int(g.step) == base.host_step + k
          and int(mg["skipped"]) == 0 and bool(mg["finite"]),
          f"chunk state: host {g.host_step}, step {int(g.step)}, skipped "
          f"{int(mg['skipped'])}")

    g, _ = chunk(g, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_CHUNKS):
        g, m = chunk(g, scene)
        losses.append(m["loss_mean"].clone())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = TRAIN_CHUNKS * k
    ms = 1e3 * secs / steps
    rate = spec.rays_per_batch * (hyper.nc + hyper.nc + hyper.nf) / (secs / steps)
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), f"chunk losses not finite: {losses}")
    check(chunk.captures == 1, "the chunk captured again on the same state")
    print(f"[train chunk] bench.py recipe, chunks of {k} (one CUDA graph replay "
          f"each): {TRAIN_CHUNKS} chunks after warm-up, {ms:.3f} ms/step against "
          f"{eager['ms']:.3f} eager ({eager['ms'] / ms:.2f}x), {rate:.1f} train "
          f"ray-samples/s against {eager['rate']:.1f}, peak memory {peak:.3f} GiB "
          f"(the first call: capture and the warm-up step on a copy) against "
          f"{eager['peak']:.3f} | {card}", flush=True)

    def one_chunk():
        nonlocal g
        g, _ = chunk(g, scene)
    traced = profile_frame(torch, one_chunk, f"train chunk profile, {k} steps", card)
    figures.update(chunk_ms=ms, chunk_idle=None if traced is None else traced[2])

    # a poisoned texel: every step of the chunk non-finite, all held
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    kcfg = KPlanesConfig((64, 128), 8, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
    khyper = ts.TrainHyper(model=NeRFConfig(kcfg.out_dim, 27, 8, 256, 4), nc=hyper.nc,
                           nf=hyper.nf, sigma_activation="relu", white_bkgd=False,
                           samp_near=NEAR_360, samp_far=FAR_360, pos_encoder="kplanes",
                           enc_cfg=kcfg, scene_contraction=True, lindisp=True,
                           kp_tv_weight=1e-4)
    ktx = ts.make_optimizer(5e-4, "cosine", {"T_max": 50_000, "eta_min": 5e-6},
                            grid_lr=1e-2)
    kstate = ts.init_train_state(khyper, ktx, near=NEAR_360, far=FAR_360,
                                 generator=torch.Generator().manual_seed(3), device=dev)
    kchunk = ts.build_train_step(khyper, spec, ktx, pos_b, dir_b, scan_steps=k,
                                 device=dev)
    with torch.no_grad():
        kstate.model_f.pos_grid.plane0_xy[0, 0, 0] = float("inf")
    # detached: a clone that records a graph would keep the parameters'
    # gradient accumulators alive on this stream, which a capture refuses
    before = [t.detach().clone() for t in ts.state_tensors(kstate)]
    t0 = time.perf_counter()
    kstate, km = kchunk(kstate, scene)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    after = ts.state_tensors(kstate)
    held = all(torch.equal(x, y) for x, y in zip(after[1:], before[1:]))
    print(f"[train chunk] 360 k-planes recipe, one texel at inf, one captured "
          f"chunk ({k_s:.3f} s with its capture): skipped {int(km['skipped'])} of "
          f"{k}, finite {bool(km['finite'])}, state held {held}, step "
          f"{int(before[0])} -> {int(after[0])}", flush=True)
    check(int(km["skipped"]) == k and not bool(km["finite"]) and held
          and int(after[0]) == int(before[0]) + k and kstate.host_step == k,
          "the poisoned chunk was not skipped and held")


def phase_kp_narrow(torch, dev, card, ctx, kernels):
    """4b4, 5b4: the 360 configuration with 4-feature planes (planes (64, 128)
    x 4, lines 512 x 16, hybrid 6: 63 columns), whose texels the kernels read
    in groups of 4: K2 with K2c + K3 on phase 4b's fine tile against its plain
    version and K3's encode-only entry bit for bit, timed with their bounds;
    then one 800x800 frame through ``render_pose`` and one
    ``nerf_forward_pass`` through K3 + K1, counted. → launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import scene_contract, vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)

    src = "nerf_sandbox_tpu_torch/csrc/"
    kcfg = KPlanesConfig((64, 128), 4, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
    cfg = NeRFConfig(kcfg.out_dim, 27, 8, 256, 4)
    model = NeRFMLP(cfg, generator=torch.Generator().manual_seed(5), grid_cfg=kcfg,
                    device=dev)
    mlp, grid = fm.pack_nerf_params(model), ke.pack_kplanes(model.pos_grid, kcfg)
    ep, P = fm._enc_pads(cfg)[0], cfg.enc_pos_dim
    ro, rd, rn, vd, z, enc_dir = (ctx[k] for k in ("ro", "rd", "rn", "vd", "z",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    kw = dict(kp_params=grid, kp_cfg=kcfg, scene_contraction=True)
    got = fr.fused_raymarch(mlp, ro, rd, z, rn, enc_dir, None, **kw)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid))
    pts = scene_contract((ro[:, None, :] + rd[:, None, :] * (z * rn)[..., None])
                         .reshape(-1, 3))
    last = pts.reshape(B, N, 3)[:, -1]
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(mlp, ke.fused_kplanes_encode(grid, last, ep)[:, :P],
                            enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(mlp, ke.kplanes_encode_plain(grid, last, ep)[:, :P],
                                  enc_dir)[:, 3])])
    print(f"[K2c+K3 F=4] kink band |logit| < {bands[0]:.3g}", flush=True)
    kp_err = hold_off_kink("K2c+K3 F=4", got, want, kink)
    enc_k = ke.fused_kplanes_encode(grid, pts, ep)
    enc_p = ke.kplanes_encode_plain(grid, pts, ep)
    torch.cuda.synchronize()
    n_off = int((enc_k != enc_p).sum())
    enc_err = max_diff(enc_k.float(), enc_p.float())
    print(f"[K3 F=4] encode-only {pts.shape[0]} rows x {ep}: {n_off} of "
          f"{enc_k.numel()} values differ from the plain version", flush=True)
    check(n_off == 0, f"K3 F=4 encode-only differs from its plain version in {n_off} values")
    kp_ms = cuda_ms(torch, lambda: fr.fused_raymarch(mlp, ro, rd, z, rn, enc_dir, None,
                                                     **kw))
    kp_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid), reps=3)
    Q = B * N
    enc_ms, enc_ev_ms = k3_times(torch, ke, grid, pts, ep, "K3 F=4", card)
    enc_plain_ms = cuda_ms(torch, lambda: ke.kplanes_encode_plain(grid, pts, ep), reps=3)
    kp_flops = kplanes_fp32_flops(kcfg) * Q
    b_kp = bound(2.0 * mlp_macs_per_row(cfg) * Q, B * (7 + 27) * 4 + Q * 4 * 3
                 + B * 5 * 4 + mlp.flat.numel() * 2 + grid.flat.numel() * 2,
                 kp_flops + 20.0 * Q)
    b_enc = bound(0.0, Q * 3 * 4 + Q * ep * 2 + grid.flat.numel() * 2, kp_flops)
    print(f"[K2c+K3 F=4] fine tile {B}x{N} kernel {kp_ms:.3f} ms, plain "
          f"{kp_plain_ms:.3f} ms, bound {b_kp[0]:.3f} ms ({b_kp[1]}); K3 encode-only "
          f"{Q} rows kernel {enc_ms:.4f} ms (device; one call {enc_ev_ms:.4f} ms), "
          f"plain {enc_plain_ms:.3f} ms, bound {b_enc[0]:.4f} ms ({b_enc[1]}), "
          f"{100.0 * b_enc[0] / enc_ms:.1f}% | {card}", flush=True)
    kernels["fused_raymarch_kplanes_f4"] = dict(
        name="fused_raymarch_kplanes_f4", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=kp_err,
        ms=kp_ms, plain_ms=kp_plain_ms, bound_ms=b_kp[0], bound_by=b_kp[1],
        library_ms=None)
    kernels["kplanes_encode_f4"] = dict(
        name="kplanes_encode_f4", route="cuda", source=src + "kplanes_encode.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=enc_err,
        ms=enc_ms, plain_ms=enc_plain_ms, bound_ms=b_enc[0], bound_by=b_enc[1],
        library_ms=None)

    # the F = 4 slice, counted
    _, dir_bands = vanilla_encoders()
    hyper = EvalHyper(model=cfg, samp_near=NEAR_360, samp_far=FAR_360, lindisp=True,
                      scene_contraction=True, pos_encoder="kplanes", enc_cfg=kcfg,
                      use_kernel=True)
    tile_k = make_tile_renderer(hyper, None, dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    ke.fused_kplanes_encode.launches = 0
    fm.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    frame = render_pose(tile_k, model, model, orbit_360_pose(1), IMG, IMG, ctx["Kmat"],
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with torch.no_grad():
        fwd = nerf_forward_pass(model, ro, rd, z, pos_bands=None, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=rn, viewdirs_world_unit=vd,
                                infinite_last_bin=True, compute_dtype=torch.bfloat16,
                                use_kernel=True, pos_encoder="kplanes", enc_cfg=kcfg,
                                scene_contraction=True, device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_kplanes_f4": routes["kplanes"],
                "kplanes_encode_f4": ke.fused_kplanes_encode.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    check(routes["kplanes"] == routes["contract"] == 2 * n_tiles,
          f"the F = 4 frame: K2 routes {routes}, expected {2 * n_tiles} k-planes launches")
    check(launches["kplanes_encode_f4"] >= 1 and fm.fused_nerf_apply.launches >= 1,
          "K3's encode-only entry or K1 was not launched on the F = 4 path")
    for key in ("rgb", "acc", "depth"):
        check(np.isfinite(frame[key]).all(), f"F = 4 frame {key} not finite")
    check(frame["rgb"].min() >= 0.0 and frame["rgb"].max() <= 1.0,
          "F = 4 frame rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K3 + K1 F = 4 forward vs K2 comp max |diff| {fwd_err}")
    print(f"[slice 360 F=4] one {IMG}x{IMG} frame {secs:.3f} s, launches {launches}, "
          f"K2 routes {routes}; nerf_forward_pass vs K2 on the tile, off the kink: "
          f"comp max|diff| {fwd_err:.3g} | {card}", flush=True)
    return launches


def phase_precision_probe(torch, dev, card, kernels):
    """7: K5 on the TPU probe's shapes in every mode, counted, each output
    held against its plain version; timed beside ``torch.matmul``. → its
    launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.ops import precision_probe as pp

    torch.cuda.synchronize()
    pp.precision_dot.launches = 0
    rows = pp.run_probe(dev)
    torch.cuda.synchronize()
    launches = {"precision_probe": pp.precision_dot.launches}
    check(launches["precision_probe"] == len(rows),
          f"K5 launched {launches['precision_probe']} times for {len(rows)} products")
    worst = 0.0
    for r in rows:
        a, b = r["a"], r["b"]
        plain = pp.precision_dot_plain(a, b, r["mode"])
        diff = (r["out"].double() - plain).abs()
        tol = a.shape[1] * 2.0 ** -23 * (a.double().abs() @ b.double().abs())
        ok = bool((diff <= tol).all())
        worst = max(worst, float(diff.max()))
        print(f"[K5] {r['shape']:24s} {r['mode']:7s} vs f64: max_abs "
              f"{r['max_abs']:.3e} max_rel {r['max_rel']:.3e}; kernel vs plain "
              f"max|diff| {float(diff.max()):.3e} (within K 2^-23 sum|a||b|: {ok})",
              flush=True)
        check(ok and np.isfinite(r["max_abs"]),
              f"K5 {r['shape']} {r['mode']} differs from its plain version")
    # single launches are shorter than their host overhead: time them from
    # CUDA graphs of 100 calls, each shape in every mode beside torch.matmul
    table = {}
    for shape in dict.fromkeys(r["shape"] for r in rows):
        a, b = next((r["a"], r["b"]) for r in rows if r["shape"] == shape)
        t = {m: graph_ms(torch, lambda m=m: pp.precision_dot(a, b, m)) for m in pp.MODES}
        t["matmul"] = graph_ms(torch, lambda: torch.matmul(a, b))
        table[shape] = t
        print(f"[K5] {shape:24s} {a.shape[0]}x{a.shape[1]}x{b.shape[1]} us per launch: "
              + ", ".join(f"{m} {1e3 * v:.2f}" for m, v in t.items())
              + f"; every mode at or under torch.matmul: "
              f"{all(t[m] <= t['matmul'] for m in pp.MODES)} | {card}", flush=True)
    a, b = next((r["a"], r["b"]) for r in rows if r["shape"].startswith("one-hot"))
    times = table[next(s for s in table if s.startswith("one-hot"))]
    plain_ms = graph_ms(torch, lambda: pp.precision_dot_plain(a, b, "fp32"))
    lib_ms = times["matmul"]
    M, K = a.shape
    N = b.shape[1]
    b_k5 = bound(0.0, (M * K + K * N + M * N) * 4, 2.0 * M * K * N)
    print(f"[K5] {M}x{K}x{N}: plain fp32 (fp64 product) {plain_ms:.4f} ms, bound "
          f"{b_k5[0]:.2e} ms ({b_k5[1]}) | {card}", flush=True)
    kernels["precision_probe"] = dict(
        name="precision_probe", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/precision_probe.cu",
        replaces="scripts/probe_mosaic_precision.py:26", max_abs_err=worst,
        ms=times["fp32"], plain_ms=plain_ms, bound_ms=b_k5[0], bound_by=b_k5[1],
        library_ms=lib_ms)
    return launches


def write_blender_scene(root, images, K, c2ws, splits):
    """A Blender dataset (``transforms_<split>.json`` + PNGs written by
    ``data/png.py``) of the given frames; ``splits`` maps a split name to
    frame indices."""
    import numpy as np

    from nerf_sandbox_tpu_torch.data.png import write_png
    W = images[0].shape[1]
    angle = float(2.0 * np.arctan(0.5 * W / float(K[0, 0])))
    for split, idx in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in idx:
            write_png(os.path.join(root, split, f"r_{i}.png"), images[i])
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.asarray(c2ws[i]).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)


CLI_STEPS, CLI_RESUME_STEPS, CLI_CKPT_EVERY, CLI_PATH_FRAMES = 200, 220, 100, 2
CLI_EVAL_CHUNK = 16384     # rays per render tile, passed as --eval_chunk


def predicted_dispatches(start, max_steps, scan, scan_from, val_steps, ckpt_every,
                         hierarchical=True, update_every=0):
    """The steps each dispatch of a training loop takes under the JAX
    trainer's rule (trainer.py:1340-1372), written out here: a chunk of
    ``scan`` steps from step ``scan_from`` on wherever it ends at or before
    the next boundary (validation, checkpoint, the end, the 500-step mark
    under hierarchical sampling only, and every ``update_every``-th step,
    the occupancy grid's update)."""
    out, step = [], start - 1
    while step < max_steps:
        s = step + 1
        bound = min(next((v for v in val_steps if v >= s), max_steps),
                    ((s - 1) // ckpt_every + 1) * ckpt_every, max_steps)
        if hierarchical:
            bound = min(bound, ((s - 1) // 500 + 1) * 500)
        if update_every:
            bound = min(bound, ((s - 1) // update_every + 1) * update_every)
        n = scan if scan > 1 and step >= scan_from - 1 and step + scan <= bound else 1
        out.append(n)
        step += n
    return out


def dispatch_text(dispatches, start):
    """'100 x 1 from 1, 6 x 16 from 101, 4 x 1 from 197' for a list of
    steps per dispatch."""
    runs, step = [], start
    for n in dispatches:
        if runs and runs[-1][1] == n:
            runs[-1][2] += 1
        else:
            runs.append([step, n, 1])
        step += n
    return ", ".join(f"{c} x {n} from {s0}" for s0, n, c in runs)


def k2_launches(H, W, passes=2):
    """K2 launches of one H x W render through the kernel, as
    ``render/renderer.py:render_rays_chunked`` tiles it: one launch per tile
    of ``CLI_EVAL_CHUNK`` rays and pass; hierarchical sampling makes a
    coarse and a fine pass (``passes`` 2), occupancy and proposal sampling
    one pass of the main model (1: the grid or the plain proposal MLP
    places its samples). The trainer's start-up probe is one 8 x 8 render."""
    return passes * -(-(H * W) // CLI_EVAL_CHUNK)


def phase_cli(torch, card, bare_ms, figures):
    """9: the port's ``train_nerf`` CLI, in-process, on ``bench.py``'s scene
    written to disk as a Blender dataset (3 train frames, the 4th as val and
    test) by ``data/png.py`` and read back through the port's loader (the
    images must come back bit for bit). Then:

    * ``--vanilla --max_steps 200 --ckpt_every 100``: one validation at step
      200, PSNR-scored on the plain path (``--val_exact``), and one progress
      frame through K2; the loss at step 200 must be below the loss at step
      1; ms/step through the CLI (the loop's time less validation and
      checkpoints, over its steps) beside phase 8's bare step;
    * ``--resume latest --max_steps 220``: must start at step 201;
    * ``--resume latest --render_only --progress_frames 2``: two 800x800
      path frames through K2, every output finite, s/frame.

    K2's launches are counted in each run's window (counts set to 0 just
    before ``main``, read just after) and must equal the kernel gate's
    prediction: per render, one launch per 16384-ray tile and pass, for the
    start-up probe (8x8) and every throughput frame, and none for the scored
    validation. The checkpoints' sizes are printed. → {kernel: launches} of
    the ``--render_only`` window (K2 only: the CLI's renders run K1's MLP
    inside K2)."""
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.data.blender_loader import BlenderSceneLoader
    from nerf_sandbox_tpu_torch.data.png import read_png
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        images, K, c2ws = bench_frames()
        data = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = BlenderSceneLoader(data).load("train")
        read_s = time.perf_counter() - t0
        same = all(np.array_equal(read_png(os.path.join(data, "train", f"r_{i}.png")),
                                  images[i]) for i in range(3))
        same_f = all(np.array_equal(f.image, images[i].astype(np.float32) / 255.0)
                     for i, f in enumerate(loaded.frames))
        print(f"[cli] wrote bench.py's scene as a Blender dataset (3 train, val = "
              f"test = frame 3) in {write_s:.2f} s; the loader read the train "
              f"split back in {read_s:.2f} s; PNGs bit-equal to the arrays: "
              f"{same}, loader images = arrays / 255 bit for bit: {same_f}",
              flush=True)
        check(same and same_f, "the PNG round trip changed the images")

        out = os.path.join(tmp, "exp")
        base = ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
                "--vanilla", "--ckpt_every", str(CLI_CKPT_EVERY),
                "--num_val_steps", "1", "--log_every", "100",
                "--eval_chunk", str(CLI_EVAL_CHUNK)]

        def counted(argv):
            torch.cuda.synchronize()
            fm.fused_nerf_apply.launches = 0
            fr.reset_launches()
            t0 = time.perf_counter()
            trainer = train_nerf(argv)
            torch.cuda.synchronize()
            return (trainer, time.perf_counter() - t0, fr.fused_raymarch.launches,
                    dict(fr.fused_raymarch.route_launches),
                    fm.fused_nerf_apply.launches)

        # ---- train 200 steps ----
        trainer, wall, k2, routes, k1 = counted(
            base + ["--max_steps", str(CLI_STEPS), "--progress_video_during_training",
                    "--progress_frames", "1"])
        st = trainer.run_stats
        check(trainer.eval_hyper.use_kernel and not trainer.eval_hyper_scored.use_kernel,
              "the kernel gate did not pick K2 for throughput renders and the "
              "plain path for the scored validation")
        # the scored validation renders on the plain path (--val_exact)
        probe, per_frame, scored = k2_launches(8, 8), k2_launches(IMG, IMG), 0
        want = probe + per_frame + scored
        loss1 = float(st["first_loss"])
        loss_end = st["losses"][-1][1]
        steps = st["steps"]
        cli_ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / steps
        figures["cli_ms"] = cli_ms
        val = st["val"]
        print(f"[cli] train {steps} steps (--vanilla, {trainer.spec.rays_per_batch} "
              f"rays, 8x256, 64+128, bf16): {wall:.2f} s in main, loop "
              f"{st['loop_s']:.2f} s of which validation {st['val_s']:.2f} s and "
              f"checkpoints {st['ckpt_s']:.2f} s; {cli_ms:.3f} ms/step through the "
              f"CLI vs {bare_ms:.3f} ms/step bare (phase 8) | {card}", flush=True)
        print(f"[cli] loss at step 1 {loss1:.6f}, at step {st['end_step']} "
              f"{loss_end:.6f}; validation at step {val['step']} (scored, plain "
              f"path): PSNR {val['psnr_mean']:.4f} dB, SSIM {val['ssim_mean']:.5f}",
              flush=True)
        print(f"[cli] K2 launches in the train window: {k2} (routes {routes}), "
              f"gate's prediction {want} = probe {probe} + progress frame "
              f"{per_frame} + scored validation {scored}; K1 launches {k1}",
              flush=True)
        want_d = predicted_dispatches(1, CLI_STEPS, 16, 101, trainer.val_steps,
                                      CLI_CKPT_EVERY)
        print(f"[cli] dispatches (the default --scan_steps 16): "
              f"{dispatch_text(st['dispatches'], 1)}; JAX's rule predicts "
              f"{dispatch_text(want_d, 1)}", flush=True)
        check(st["dispatches"] == want_d, "the chunk schedule is not JAX's")
        check(st["end_step"] == CLI_STEPS, f"training ended at {st['end_step']}")
        check(np.isfinite(loss1) and np.isfinite(loss_end) and loss_end < loss1,
              f"the loss did not fall: {loss1} at step 1, {loss_end} at "
              f"{st['end_step']}")
        check(np.isfinite(val["psnr_mean"]) and np.isfinite(val["ssim_mean"]),
              "validation PSNR / SSIM not finite")
        check(k2 == want and routes["freq"] == want,
              f"K2 launched {k2} times ({routes}), the gate predicts {want}")
        ck = os.path.join(out, "checkpoints")
        sizes = {f: os.path.getsize(os.path.join(ck, f)) for f in sorted(os.listdir(ck))
                 if not os.path.islink(os.path.join(ck, f))}
        print(f"[cli] checkpoints (bytes): {sizes}", flush=True)
        check(f"ckpt_{CLI_CKPT_EVERY:07d}.ckpt" in sizes
              and f"ckpt_{CLI_STEPS:07d}.ckpt" in sizes,
              f"missing checkpoints: {sorted(sizes)}")

        # ---- resume to 220 ----
        trainer, wall, k2, routes, _ = counted(
            base + ["--max_steps", str(CLI_RESUME_STEPS), "--resume", "latest"])
        st = trainer.run_stats
        want_d = predicted_dispatches(CLI_STEPS + 1, CLI_RESUME_STEPS, 16, 101,
                                      trainer.val_steps, CLI_CKPT_EVERY)
        print(f"[cli] --resume latest --max_steps {CLI_RESUME_STEPS}: started at "
              f"step {st['start_step']}, ended at {st['end_step']}, loss "
              f"{st['losses'][-1][1]:.6f}; dispatches "
              f"{dispatch_text(st['dispatches'], st['start_step'])} (JAX's rule: "
              f"{dispatch_text(want_d, CLI_STEPS + 1)}); {wall:.2f} s in main",
              flush=True)
        check(st["start_step"] == CLI_STEPS + 1,
              f"the resumed run started at step {st['start_step']}")
        check(st["dispatches"] == want_d and st["dispatches"][0] == 16,
              f"the resumed run did not chunk 201-216: {st['dispatches']}")
        check(st["end_step"] == CLI_RESUME_STEPS, f"resume ended at {st['end_step']}")

        # ---- render_only: two path frames through K2 ----
        trainer, wall, k2, routes, _ = counted(
            base + ["--max_steps", str(CLI_RESUME_STEPS), "--resume", "latest",
                    "--render_only", "--progress_frames", str(CLI_PATH_FRAMES)])
        ps = trainer.path_renderer.path_stats
        want = probe + CLI_PATH_FRAMES * per_frame
        secs = [p["seconds"] for p in ps]
        print(f"[cli] --render_only: {len(ps)} path frames {IMG}x{IMG} through K2, "
              f"{secs} s ({secs[-1]:.3f} s/frame steady); {wall:.2f} s in main; "
              f"K2 launches {k2} (routes {routes}), gate's prediction {want} = "
              f"probe {probe} + {CLI_PATH_FRAMES} x {per_frame} | {card}", flush=True)
        check(len(ps) == CLI_PATH_FRAMES and all(p["finite"] for p in ps),
              f"path frames missing or not finite: {ps}")
        check(k2 == want and routes["freq"] == want,
              f"K2 launched {k2} times ({routes}) in --render_only, the gate "
              f"predicts {want}")
        launches = {"fused_raymarch": k2}
        KEPT["cli"] = keep_run(data, out)
        phase_cli_async(torch, card, data, tmp, counted, probe, per_frame)
        print(f"[cli] phase 9 took {time.perf_counter() - t_phase:.2f} s", flush=True)
        t_phase = time.perf_counter()
        phase_cli_360(torch, card, data, os.path.join(tmp, "exp360"), counted)
        print(f"[cli 360] phase 9b took {time.perf_counter() - t_phase:.2f} s",
              flush=True)
        phase_cli_occupancy(torch, card, data, tmp, counted, figures)
        phase_cli_proposal(torch, card, data, tmp, counted, figures)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ASYNC_STEPS = 40


def phase_cli_async(torch, card, data, tmp, counted, probe, per_frame):
    """9, ``--async_val``: 40 ``--vanilla`` steps in chunks of 4
    (``--scan_steps 4``) with 2 validations through K2 (``--val_exact
    false``), once synchronously and once with the worker rendering on its
    own stream while the graphs replay. The validation PNGs must be
    byte-identical, and each run's K2 launches the gate's prediction
    (the probe and two 800x800 frames)."""
    argv = ["--data_kind", "blender", "--data_root", data, "--vanilla",
            "--max_steps", str(ASYNC_STEPS), "--scan_steps", "4", "--num_val_steps", "2",
            "--ckpt_every", str(ASYNC_STEPS), "--log_every", str(ASYNC_STEPS),
            "--val_exact", "false", "--eval_chunk", str(CLI_EVAL_CHUNK)]
    want = probe + 2 * per_frame
    pngs = {}
    for mode in ("false", "true"):
        out = os.path.join(tmp, f"exp_async_{mode}")
        trainer, wall, k2, routes, _ = counted(argv + ["--out_dir", out,
                                                       "--async_val", mode])
        st = trainer.run_stats
        root = os.path.join(out, "validation")
        pngs[mode] = {os.path.relpath(os.path.join(d, f), root):
                      open(os.path.join(d, f), "rb").read()
                      for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}
        print(f"[cli async] --async_val {mode}: {st['steps']} steps "
              f"({dispatch_text(st['dispatches'], 1)}), validations at "
              f"{trainer.val_steps} through K2 in {st['val_s']:.2f} s of the loop's "
              f"{st['loop_s']:.2f} s; {len(pngs[mode])} PNGs; K2 launches {k2} "
              f"(routes {routes}), gate's prediction {want}; {wall:.2f} s in main "
              f"| {card}", flush=True)
        check(st["end_step"] == ASYNC_STEPS and max(st["dispatches"]) == 4,
              f"--async_val {mode}: ended at {st['end_step']}, {st['dispatches']}")
        check(k2 == want == routes["freq"],
              f"--async_val {mode}: K2 launched {k2} ({routes}), the gate predicts {want}")
    same = pngs["true"] == pngs["false"]
    print(f"[cli async] validation PNGs of the async run byte-identical to the "
          f"synchronous run's: {same} ({sorted(pngs['true'])})", flush=True)
    check(same and len(pngs["true"]) == 6, "async validation artifacts differ")


CLI360_STEPS, CLI360_RES = 20, 0.25


def phase_cli_360(torch, card, data, out, counted):
    """9b: the unbounded-360 k-planes recipe through the CLI on the same
    scene, its rig scaled into the unit ball (``--scene_scale 0.25``):
    planes (64, 128) x 8, lines 512 x 16, hybrid 6 (the defaults), aabb
    raised to 2 under ``--scene_contraction``, lindisp from 0.125 to 22.5,
    ``--lr_grid 1e-2``, a small distortion loss; eval renders with the
    planes pooled to (32, 64) (``--eval_kp_pool 2``) and the validation at
    half size (``--val_res_scale 0.5``); 20 steps, the validation scored
    through K2 (``--val_exact false``, since the plain k-planes frame takes
    ~17 s), then one ``--render_only`` path frame at a quarter of the size.
    The gate must pick K2 with K2c + K3: every launch in both windows on the
    k-planes route with contraction and on the pooled tables, as many as it
    predicts. The path frame through K2 is then held against the plain path
    on the same pooled models (max |drgb| <= 2e-2 off the last-bin kink, at
    most 5% of the pixels at the kink, PSNR >= 40 dB)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.render import renderer as rr

    pooled = (32, 64)
    argv = ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
            "--scene_scale", "0.25", "--near_world", "0.125", "--far_world", "22.5",
            "--lindisp", "true", "--scene_contraction", "true", "--encoder", "kplanes",
            "--lr_grid", "1e-2", "--distortion_weight", "1e-3", "--white_bkgd", "false",
            "--rays_per_batch", "1024", "--max_steps", str(CLI360_STEPS),
            "--num_val_steps", "1", "--log_every", str(CLI360_STEPS),
            "--ckpt_every", str(CLI360_STEPS), "--val_exact", "false",
            "--eval_kp_pool", "2", "--val_res_scale", "0.5",
            "--eval_chunk", str(CLI_EVAL_CHUNK)]
    tables = []          # the plane resolution each K2 launch was given
    real = rr.fused_raymarch

    def recording(*a, **kw):
        grid = kw.get("kp_params")
        tables.append(None if grid is None else tuple(
            grid.views[f"plane{s}_xy"].shape[0] for s in range(len(pooled))))
        return real(*a, **kw)
    rr.fused_raymarch = recording
    try:
        trainer, wall, k2, routes, _ = counted(argv)
        train_tables, tables[:] = list(tables), []
        st = trainer.run_stats
        probe = k2_launches(8, 8)
        half = IMG // 2
        want = probe + k2_launches(half, half)
        ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / st["steps"]
        print(f"[cli 360] {st['steps']} steps of the k-planes 360 recipe through the "
              f"CLI: {ms:.3f} ms/step, loss {float(st['first_loss']):.6f} -> "
              f"{st['losses'][-1][1]:.6f}; validation at {half}x{half} through K2 "
              f"on planes pooled to {trainer.eval_enc_cfg.plane_res} "
              f"{st['val_s']:.2f} s, PSNR {st['val']['psnr_mean']:.4f} dB; K2 "
              f"launches {k2} (routes {routes}), gate's prediction {want}, planes "
              f"per launch {sorted(set(train_tables))}; {wall:.2f} s in main | {card}",
              flush=True)
        check(trainer.eval_hyper.use_kernel and trainer.eval_hyper.pos_encoder == "kplanes"
              and trainer.eval_hyper.scene_contraction,
              "the gate did not pick K2 with K2c + K3 for the 360 recipe")
        check(trainer.eval_enc_cfg.plane_res == pooled
              and trainer.enc_cfg.plane_res == (64, 128),
              f"eval planes {trainer.eval_enc_cfg.plane_res}, training planes "
              f"{trainer.enc_cfg.plane_res}")
        check(np.isfinite(st["losses"][-1][1]), "360 CLI loss not finite")
        check(k2 == want == routes["kplanes"] == routes["contract"],
              f"360 training window: K2 {k2} ({routes}), the gate predicts {want}")
        check(train_tables == [pooled] * want,
              f"360 training window: K2 ran on planes {sorted(set(train_tables))}")
        trainer, wall, k2, routes, _ = counted(
            argv + ["--resume", "latest", "--render_only", "--progress_frames", "1",
                    "--path_res_scale", str(CLI360_RES)])
        path_tables = list(tables)
    finally:
        rr.fused_raymarch = real
    ps = trainer.path_renderer.path_stats
    side = int(round(IMG * CLI360_RES))
    want = probe + k2_launches(side, side)
    print(f"[cli 360] --render_only: 1 path frame {side}x{side} in "
          f"{ps[0]['seconds']:.3f} s, K2 launches {k2} (routes {routes}), gate's "
          f"prediction {want}, planes per launch {sorted(set(path_tables))} | {card}",
          flush=True)
    check(len(ps) == 1 and ps[0]["finite"], f"360 path frame missing or not finite: {ps}")
    check(k2 == want == routes["kplanes"] == routes["contract"],
          f"360 --render_only: K2 {k2} ({routes}), the gate predicts {want}")
    check(path_tables == [pooled] * want,
          f"360 --render_only: K2 ran on planes {sorted(set(path_tables))}")
    pooled_frame_vs_plain(torch, card, trainer)


def occupancy_last_z(torch, grid, h, dev, c2w, Kmat, H, W):
    """Each ray's last sample of an occupancy frame (grid ``grid``, eval
    hyper ``h``): the grid's probes and the deterministic inverse-CDF draw
    the tile renderer makes → (H·W,)."""
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import sample_pdf
    from nerf_sandbox_tpu_torch.models.occupancy import ray_probe_weights

    rays = get_camera_rays_grid(torch.from_numpy(Kmat).to(dev),
                                torch.from_numpy(c2w).to(dev), image_h=H, image_w=W,
                                pixel_center=True)
    with torch.no_grad():
        z, w = ray_probe_weights(grid, h.occ_cfg, rays.o_march, rays.d_march_unit,
                                 rays.d_march_norm, h.samp_near, h.samp_far)
        return sample_pdf(z, w, h.nf_eval, deterministic=True).max(dim=-1).values


def pooled_frame_vs_plain(torch, card, trainer, tag="cli 360"):
    """9b and 10a: the ``--render_only`` path frame of the trainer's eval
    models through K2 (the trainer's tile renderer) and through the plain
    path, held as phase 5b holds its frame. → (K2 s, plain s)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.render.renderer import make_tile_renderer, render_pose
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    valr = trainer.path_renderer
    H, W, K = valr._prog_H, valr._prog_W, valr._prog_K
    c2w = valr._prog_poses[0]
    model_c, model_f = trainer.eval_models()
    plain_tile = make_tile_renderer(trainer.eval_hyper._replace(use_kernel=False),
                                    trainer.pos_bands, trainer.dir_bands,
                                    device=trainer.device)
    frames = {}
    for name, tile in (("K2", trainer.render_tile), ("plain", plain_tile)):
        t0 = time.perf_counter()
        frames[name] = render_pose(tile, model_c, model_f, c2w, H, W, K,
                                   eval_chunk=CLI_EVAL_CHUNK, device=trainer.device)
        torch.cuda.synchronize()
        frames[name]["s"] = time.perf_counter() - t0
    z_last = (occupancy_last_z(torch, trainer.occ_grid, trainer.eval_hyper,
                               trainer.device, c2w, K, H, W)
              if trainer.sampling_mode == "occupancy" else None)
    kink, bands = kp_frame_kink(torch, trainer.device, model_c, model_f,
                                trainer.eval_enc_cfg, c2w, K, H, W, trainer.far_world,
                                z_last=z_last)
    drgb = np.abs(frames["K2"]["rgb"] - frames["plain"]["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames["K2"]["rgb"], frames["plain"]["rgb"])
    print(f"[{tag}] path frame {W}x{H}, K2 {frames['K2']['s']:.3f} s vs plain "
          f"{frames['plain']['s']:.3f} s: max|drgb| {d_rgb:.3g} off the kink (tol "
          f"2e-2); {int(kink.sum())} pixels at the kink (|logit| < {bands}), "
          f"PSNR {psnr:.2f} dB (min 40) | {card}", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"{tag} frame: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"{tag} frame kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"{tag} frame kernel vs plain PSNR {psnr:.2f} dB < 40")
    return frames["K2"]["s"], frames["plain"]["s"]


OCC_STEPS, OCC_CKPT, OCC_SCAN, OCC_UPDATE = 64, 32, 8, 16
OCC_CHUNK, OCC_CHUNKS = 16, 4


def _occ_argv(data, out):
    """10a: phase 9b's scene with the README's unbounded-360 occupancy flags
    (README.md:161-166), at full width."""
    return ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
            "--scene_scale", "0.25", "--near_world", "0.125", "--far_world", "22.5",
            "--lindisp", "true", "--scene_contraction", "true",
            "--distortion_weight", "0.01", "--sampling", "occupancy",
            "--occ_explore_anneal", "1000", "--encoder", "kplanes", "--lr_grid", "1e-2",
            "--kp_hybrid_freqs", "6", "--white_bkgd", "false", "--rays_per_batch", "1024",
            "--scan_steps", str(OCC_SCAN), "--max_steps", str(OCC_STEPS),
            "--ckpt_every", str(OCC_CKPT), "--num_val_steps", "1",
            "--log_every", str(OCC_STEPS), "--val_exact", "false",
            "--val_res_scale", "0.5", "--eval_chunk", str(CLI_EVAL_CHUNK)]


def _run_state(trainer):
    """Every tensor a run ends with: the state and the occupancy grid."""
    from nerf_sandbox_tpu_torch.train import step as ts
    return ts.state_tensors(trainer.state) + [trainer.occ_grid]


def _tile_launches(fr):
    return dict(sorted(fr.fused_raymarch.tile_launches.items()))


def phase_cli_occupancy(torch, card, data, tmp, counted, figures):
    """10a: ``--sampling occupancy`` on the 360 k-planes recipe through the
    CLI (``_occ_argv``; 64 steps of 1024 rays, 128 samples a ray placed by a
    64³ grid of 64 probes a ray; chunks of 8, since ``--scan_steps 16`` is
    the default and under JAX's rule engages only at step 101; a checkpoint
    at 32). Checks: the grid updated at 16, 32, 48 and 64 and the
    dispatches as ``predicted_dispatches`` places them with the update as a
    boundary; a second straight run gives the run-to-run spread; ``--resume
    latest`` from 32 to 64 bit-equal to the straight run (parameters,
    optimizer state, grid) or within that spread; every K2 launch of the
    validation (400x400) and of one ``--render_only`` frame (200x200) on the
    k-planes + contraction route at N = 128, one pass a tile, as many as
    the gate predicts; the frame against its plain version. Then, outside
    the CLI, a 16-step chunk from the run's state that ends at an update
    (steps 65-80, then the update at 80) against 16 eager steps and the
    update, run twice: bit-equal or within the eager-vs-eager spread;
    ms/step eager and chunked, one profiled chunk, and the updater's ms."""
    import shutil

    import numpy as np

    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    runs, tiles = {}, {}
    for name in ("a", "b"):
        out = os.path.join(tmp, f"occ_{name}")
        trainer, wall, k2, routes, k1 = counted(_occ_argv(data, out))
        runs[name] = trainer
        tiles[name] = _tile_launches(fr)
        st = trainer.run_stats
        want_d = predicted_dispatches(1, OCC_STEPS, OCC_SCAN, 1, trainer.val_steps,
                                      OCC_CKPT, hierarchical=False,
                                      update_every=OCC_UPDATE)
        val_side = IMG // 2
        want = k2_launches(8, 8, 1) + k2_launches(val_side, val_side, 1)
        ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / st["steps"]
        print(f"[occ 360] run {name}: {st['steps']} steps through the CLI in "
              f"{wall:.2f} s ({ms:.3f} ms/step in the loop, grid updates and "
              f"chunk captures included), loss {float(st['first_loss']):.6f} -> "
              f"{st['losses'][-1][1]:.6f}; grid updates at {st['occ_updates']}; "
              f"dispatches {dispatch_text(st['dispatches'], 1)} (predicted "
              f"{dispatch_text(want_d, 1)}); K2 launches {k2} (routes {routes}, "
              f"tiles {tiles[name]}), gate's prediction {want} = probe + "
              f"{val_side}x{val_side} validation, one pass a tile; K1 {k1} | {card}",
              flush=True)
        check(trainer.eval_hyper.use_kernel and trainer.sampling_mode == "occupancy"
              and trainer.occ_cfg.contracted and trainer.occ_cfg.resolution == 64,
              "the occupancy 360 run did not open the gate on a contracted 64^3 grid")
        check(st["occ_updates"] == [16, 32, 48, 64],
              f"grid updates at {st['occ_updates']}")
        check(st["dispatches"] == want_d, "the occupancy chunk schedule is not JAX's")
        check(np.isfinite(st["losses"][-1][1]), "occupancy loss not finite")
        check(k2 == want == routes["kplanes"] == routes["contract"]
              and tiles[name] == {("kplanes", 128): want},
              f"occupancy training window: K2 {k2} ({routes}, {tiles[name]}), the "
              f"gate predicts {want} at N = 128")
    same, spread = _bits_apart(_run_state(runs["a"]), _run_state(runs["b"]))
    print(f"[occ 360] two straight runs: "
          f"{'bit-equal' if same else f'spread max|diff| {spread:.3g}'}", flush=True)

    # ---- resume from the checkpoint at 32 ----
    out = os.path.join(tmp, "occ_resume")
    os.makedirs(os.path.join(out, "checkpoints"))
    name = f"ckpt_{OCC_CKPT:07d}.ckpt"
    shutil.copyfile(os.path.join(tmp, "occ_a", "checkpoints", name),
                    os.path.join(out, "checkpoints", name))
    trainer, wall, _, _, _ = counted(_occ_argv(data, out) + ["--resume", "latest"])
    st = trainer.run_stats
    want_d = predicted_dispatches(OCC_CKPT + 1, OCC_STEPS, OCC_SCAN, 1, trainer.val_steps,
                                  OCC_CKPT, hierarchical=False, update_every=OCC_UPDATE)
    eq, diff = _bits_apart(_run_state(runs["a"]), _run_state(trainer))
    print(f"[occ 360] --resume latest from {OCC_CKPT}: started at {st['start_step']}, "
          f"grid restored {trainer._occ_grid_restored}, updates at "
          f"{st['occ_updates']}, dispatches {dispatch_text(st['dispatches'], OCC_CKPT + 1)} "
          f"(predicted {dispatch_text(want_d, OCC_CKPT + 1)}); against the straight "
          f"run: {'bit-equal' if eq else f'max|diff| {diff:.3g}'} (parameters, "
          f"moments, counts, step, grid); {wall:.2f} s in main", flush=True)
    check(st["start_step"] == OCC_CKPT + 1 and trainer._occ_grid_restored
          and st["occ_updates"] == [48, 64] and st["dispatches"] == want_d,
          "the resumed occupancy run did not restore and follow the schedule")
    check(eq or (not same and diff <= spread),
          f"resumed run differs from the straight one by {diff:.3g} (spread "
          f"{0.0 if same else spread:.3g})")

    # ---- render_only: one 200x200 path frame ----
    trainer, wall, k2, routes, _ = counted(
        _occ_argv(data, os.path.join(tmp, "occ_a"))
        + ["--resume", "latest", "--render_only", "--progress_frames", "1",
           "--path_res_scale", str(CLI360_RES)])
    tl = _tile_launches(fr)
    valr = trainer.path_renderer
    H, W = valr._prog_H, valr._prog_W
    want = k2_launches(8, 8, 1) + k2_launches(H, W, 1)
    ps = valr.path_stats
    print(f"[occ 360] --render_only: 1 path frame {W}x{H} in "
          f"{ps[0]['seconds']:.3f} s, K2 launches {k2} (routes {routes}, tiles {tl}), "
          f"gate's prediction {want} at N = 128 | {card}", flush=True)
    check(len(ps) == 1 and ps[0]["finite"] and trainer._occ_grid_restored,
          f"occupancy path frame missing or not finite: {ps}")
    check(k2 == want == routes["kplanes"] == routes["contract"]
          and tl == {("kplanes", 128): want},
          f"occupancy --render_only: K2 {k2} ({routes}, {tl}), the gate predicts "
          f"{want} at N = 128")
    pooled_frame_vs_plain(torch, card, trainer, tag="occ 360")

    # ---- a 16-step chunk that ends at an update, against eager steps ----
    chunk = ts.build_train_step(trainer.hyper, trainer.spec, trainer.tx,
                                trainer.pos_bands, trainer.dir_bands,
                                base_seed=int(trainer.cfg.seed), scan_steps=OCC_CHUNK,
                                device=trainer.device)
    scene, k = trainer.scene_arrays, OCC_CHUNK
    start = trainer.state.host_step

    def update(st, grid):
        trainer.occ_update(grid, st.model_f, generator=trainer._occ_generator(st.host_step))

    def eager(st, grid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            st, m = chunk.step(st, scene, grid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        update(st, grid)
        return st, grid, m, secs

    base, grid0 = ts.clone_state(trainer.state), trainer.occ_grid.clone()
    a = eager(ts.clone_state(base), grid0.clone())
    b = eager(ts.clone_state(base), grid0.clone())
    keys = ("loss", "psnr", "mse_f", "finite")

    def flat(run):
        st, grid, m = run[:3]
        return ts.state_tensors(st) + [grid] + [m[n] for n in keys]
    eq_ee, d_ee = _bits_apart(flat(a), flat(b))
    g, gg = ts.clone_state(base), grid0.clone()
    g, mg = chunk(g, scene, gg)
    mg = {n: t.clone() for n, t in mg.items()}
    update(g, gg)
    eq_ge, d_ge = _bits_apart(flat(a), flat((g, gg, mg)))
    check(g.host_step == start + k and int(g.step) == start + k
          and (start + k) % OCC_UPDATE == 0, "the chunk did not end at an update")
    check(eq_ge or (not eq_ee and d_ge <= d_ee),
          f"the occupancy chunk differs from {k} eager steps by {d_ge:.3g} (eager "
          f"spread {d_ee:.3g})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OCC_CHUNKS):
        g, m = chunk(g, scene, gg)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (OCC_CHUNKS * k)
    check(bool(m["finite"]) and chunk.captures == 1,
          f"occupancy chunks: finite {bool(m['finite'])}, {chunk.captures} captures")
    eager_ms = 1e3 * b[3] / k
    print(f"[occ 360] steps {start + 1}-{start + k} and the update at {start + k}: "
          f"{k} eager steps twice "
          f"{'bit-equal' if eq_ee else f'spread max|diff| {d_ee:.3g}'}; the captured "
          f"chunk against them {'bit-equal' if eq_ge else f'max|diff| {d_ge:.3g}'} "
          f"(state, grid, loss, psnr, mse_f, finite)", flush=True)

    def one_chunk():
        nonlocal g
        g, _ = chunk(g, scene, gg)
    traced = profile_frame(torch, one_chunk, f"occ 360 chunk profile, {k} steps", card)
    idle = None if traced is None else traced[2]
    # the updater alone, on a copy of the grid
    grid = trainer.occ_grid.clone()
    trainer.occ_update(grid, g.model_f, generator=trainer._occ_generator(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        trainer.occ_update(grid, g.model_f, generator=trainer._occ_generator(i))
    torch.cuda.synchronize()
    upd_ms = 1e3 * (time.perf_counter() - t0) / 5
    figures.update(occ_eager_ms=eager_ms, occ_chunk_ms=chunk_ms, occ_idle=idle,
                   occ_update_ms=upd_ms)
    print(f"[occ 360] ms/step: eager {eager_ms:.3f}, chunked {chunk_ms:.3f} (chunks of "
          f"{k}, one CUDA graph replay each), device idle share of one profiled chunk "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; updater "
          f"{upd_ms:.3f} ms per update ({trainer.occ_cfg.resolution}^3 cells, 8x256 "
          f"bf16 MLP over the k-planes encode) | {card}", flush=True)
    print(f"[occ 360] phase 10a took {time.perf_counter() - t_phase:.2f} s", flush=True)


PROP_STEPS = 64


def phase_cli_proposal(torch, card, data, tmp, counted, figures):
    """10b: ``--vanilla --sampling proposal --prop_anneal_steps 1000`` on
    phase 9's Blender scene through the CLI: 64 steps (chunks of 8 from
    step 1), then one 800x800 validation through K2 (``--val_exact
    false``). The loss must fall; K2 launches one pass a tile at N = 128
    (the probe and the validation frame) and nothing else: the proposal MLP
    is plain (no K1 or K2 launch). Then, outside the CLI, ms/step eager and
    in 16-step chunks, and one profiled chunk."""
    import numpy as np

    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    argv = ["--data_kind", "blender", "--data_root", data,
            "--out_dir", os.path.join(tmp, "prop"), "--vanilla", "--sampling", "proposal",
            "--prop_anneal_steps", "1000", "--max_steps", str(PROP_STEPS),
            "--scan_steps", "8", "--ckpt_every", str(PROP_STEPS), "--num_val_steps", "1",
            "--log_every", "8", "--val_exact", "false", "--eval_chunk", str(CLI_EVAL_CHUNK)]
    trainer, wall, k2, routes, k1 = counted(argv)
    tl = _tile_launches(fr)
    st = trainer.run_stats
    want = k2_launches(8, 8, 1) + k2_launches(IMG, IMG, 1)
    losses = [v for _, v in st["losses"]]
    print(f"[prop] {st['steps']} steps of --vanilla --sampling proposal through the CLI "
          f"in {wall:.2f} s: proposal MLP {trainer.prop_model.n_layers}x"
          f"{trainer.prop_model.hidden_dim} at {trainer.hyper.n_prop} samples, main "
          f"8x256 at {trainer.hyper.nf}; loss {float(st['first_loss']):.6f} -> "
          f"{losses}; validation 800x800 through K2 PSNR "
          f"{st['val']['psnr_mean']:.4f} dB in {st['val_s']:.2f} s; K2 launches {k2} "
          f"(routes {routes}, tiles {tl}), gate's prediction {want}, one pass a tile; "
          f"K1 {k1} | {card}", flush=True)
    check(np.isfinite(losses).all() and losses[-1] < float(st["first_loss"]),
          "the proposal run's loss did not fall")
    check(k2 == want == routes["freq"] and tl == {("freq", 128): want} and k1 == 0,
          f"proposal window: K2 {k2} ({routes}, {tl}), K1 {k1}; the gate predicts "
          f"{want} K2 launches at N = 128 and no K1")

    chunk = ts.build_train_step(trainer.hyper, trainer.spec, trainer.tx,
                                trainer.pos_bands, trainer.dir_bands,
                                base_seed=int(trainer.cfg.seed), scan_steps=OCC_CHUNK,
                                device=trainer.device)
    scene, st_ = trainer.scene_arrays, ts.clone_state(trainer.state)
    for _ in range(2):
        st_, _ = chunk.step(st_, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OCC_CHUNK):
        st_, m = chunk.step(st_, scene)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / OCC_CHUNK
    st_, m = chunk(st_, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OCC_CHUNKS):
        st_, m = chunk(st_, scene)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (OCC_CHUNKS * OCC_CHUNK)
    check(bool(m["finite"]), "proposal chunk not finite")

    def one_chunk():
        nonlocal st_
        st_, _ = chunk(st_, scene)
    traced = profile_frame(torch, one_chunk, f"prop chunk profile, {OCC_CHUNK} steps",
                           card)
    idle = None if traced is None else traced[2]
    figures.update(prop_eager_ms=eager_ms, prop_chunk_ms=chunk_ms, prop_idle=idle)
    print(f"[prop] ms/step: eager {eager_ms:.3f}, chunked {chunk_ms:.3f} (chunks of "
          f"{OCC_CHUNK}), device idle share of one profiled chunk "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'} | {card}",
          flush=True)
    print(f"[prop] phase 10b took {time.perf_counter() - t_phase:.2f} s", flush=True)


def phase_occupancy_frame(torch, dev, card, model_f, Kmat, figures):
    """10c: one 800x800 Blender frame under occupancy sampling through K2:
    phase 5's fine model (the reference's 8x256 weights), a 64³ grid over
    ±1.5 rebuilt from it (one update of a zero grid), 128 samples a ray in
    one pass a tile. Two frames, the second timed; 40 launches a frame, all
    at N = 128; the second frame held against the plain path as phase 5
    holds its frame (each ray's last sample is where the grid's probes put
    it, ``occupancy_last_z``); one frame profiled for K2's time a tile.
    Printed beside the hierarchical figures of this run (phases 5, 8 and
    9), with the prediction written in PERF.md before the first run."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.models.occupancy import (
        OccupancyConfig, init_occupancy_grid, make_occupancy_updater)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr
    from nerf_sandbox_tpu_torch.train.step import step_seed

    pos_bands, dir_bands = vanilla_encoders()
    ocfg = OccupancyConfig()
    grid = init_occupancy_grid(ocfg, device=dev).zero_()
    upd = make_occupancy_updater(pos_bands, dir_bands, ocfg, device=dev)
    upd(grid, model_f, generator=torch.Generator(device=dev).manual_seed(step_seed(13, 0)))
    occupied = float((grid > 0).float().mean())
    hyper = EvalHyper(model=model_f.cfg, nf_eval=128, use_kernel=True,
                      sampling_mode="occupancy", occ_cfg=ocfg)
    tile = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands, dir_bands,
                                device=dev)
    secs, frames = [], []
    torch.cuda.synchronize()
    fr.reset_launches()
    for i in range(2):
        t0 = time.perf_counter()
        frames.append(render_pose(tile, grid, model_f, blender_pose(1), IMG, IMG, Kmat,
                                  eval_chunk=EVAL_CHUNK, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    tl = _tile_launches(fr)
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    check(tl == {("freq", 128): 2 * n_tiles},
          f"occupancy Blender frames: K2 tiles {tl}, expected {2 * n_tiles} at N = 128")
    for f in frames:
        check(np.isfinite(f["rgb"]).all() and f["rgb"].min() >= 0 and f["rgb"].max() <= 1,
              "occupancy Blender frame not finite or outside [0, 1]")
    t0 = time.perf_counter()
    plain = render_pose(tile_p, grid, model_f, blender_pose(1), IMG, IMG, Kmat,
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # Each ray's last sample has the infinite bin: pixels whose logit there
    # is too close to zero to call are held by the frame PSNR.
    z_last = occupancy_last_z(torch, grid, hyper, dev, blender_pose(1), Kmat, IMG, IMG)
    rays = get_camera_rays_grid(torch.from_numpy(Kmat).to(dev),
                                torch.from_numpy(blender_pose(1)).to(dev),
                                image_h=IMG, image_w=IMG, pixel_center=True)
    with torch.no_grad():
        enc_p = positional_encoding(rays.o_march + rays.d_march_unit
                                    * (z_last.reshape(-1, 1) * rays.d_march_norm),
                                    pos_bands)
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        kink, bands = last_bin_kink([(fm.fused_nerf_apply(model_f, enc_p, enc_d)[:, 3],
                                      model_f(enc_p, enc_d,
                                              compute_dtype=torch.bfloat16)[:, 3])])
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    print(f"[occ frame] frame 2 kernel vs plain path ({plain_s:.3f} s/frame): "
          f"max|drgb| {d_rgb:.3g} off the kink (tol 2e-2); {int(kink.sum())} pixels "
          f"at the kink (|logit| < {bands}), whole-frame max|drgb| "
          f"{float(drgb.max()):.3g}, PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"occupancy frame: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"occupancy frame kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"occupancy frame kernel vs plain PSNR {psnr:.2f} dB < 40")
    traced = profile_frame(torch, lambda: render_pose(
        tile, grid, model_f, blender_pose(1), IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK,
        device=dev), "occ frame profile", card)
    k2_tile = None if traced is None else 1e3 * traced[0] / n_tiles
    b128 = bound(2.0 * mlp_macs_per_row(model_f.cfg) * EVAL_CHUNK * 128, 0.0)[0]
    figures.update(occ_frame_s=secs[1], occ_k2_tile_ms=k2_tile)
    hier = figures["frame_s"]
    print(f"[occ frame] 800x800 Blender frame, occupancy sampling (64^3 grid over "
          f"+-1.5 rebuilt from phase 5's fine model, {100 * occupied:.1f}% of the cells "
          f"occupied), 128 samples a ray: {secs} s, steady {secs[1]:.3f} s/frame "
          f"against {hier:.3f} s/frame hierarchical (phase 5); K2 "
          f"{'not measured' if k2_tile is None else f'{k2_tile:.3f}'} ms a tile (profile; "
          f"bound {b128:.3f} ms) "
          f"against coarse {figures['k2_coarse_ms']:.3f} + fine "
          f"{figures['k2_fine_ms']:.3f} ms (phase 5); launches {tl} "
          f"| {card}", flush=True)


def print_sampling_figures(f, card):
    """10: the figures of the two sampling modes beside the hierarchical
    ones of the same run (``f``: the phases' figures)."""

    def pct(x):
        return "not measured" if x is None else f"{100 * x:.1f}%"
    print(f"[sampling] ms/step eager / chunked (idle share of one profiled chunk): "
          f"hierarchical bench.py recipe {f['train_ms']:.3f} / {f['chunk_ms']:.3f} "
          f"({pct(f.get('chunk_idle'))}); occupancy 360 k-planes "
          f"{f['occ_eager_ms']:.3f} / {f['occ_chunk_ms']:.3f} ({pct(f['occ_idle'])}); "
          f"proposal Blender {f['prop_eager_ms']:.3f} / {f['prop_chunk_ms']:.3f} "
          f"({pct(f['prop_idle'])}); occupancy updater {f['occ_update_ms']:.3f} ms per "
          f"update; 800x800 Blender frame {f['frame_s']:.3f} s hierarchical, "
          f"{f['occ_frame_s']:.3f} s occupancy | {card}", flush=True)


# ---------------------------------------------------------------- phase 11

def _crc_table():
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        out.append(c)
    return out


CRC32C_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli, reflected 0x82F63B78), byte by byte: the event
    reader's own, apart from the port's."""
    c = 0xFFFFFFFF
    for b in data:
        c = CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _pb_fields(buf: bytes):
    """Protobuf wire format → (field, wire type, value) in order."""
    i = 0

    def varint(i):
        n, shift = 0, 0
        while True:
            b = buf[i]
            n |= (b & 0x7F) << shift
            i += 1
            if b < 0x80:
                return n, i
            shift += 7

    while i < len(buf):
        key, i = varint(i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = varint(i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            n, i = varint(i)
            v, i = buf[i:i + n], i + n
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise PhaseError(f"event file: wire type {wt}")
        yield field, wt, v


def read_events(path):
    """A TensorBoard event file → [{"step", "file_version", "values": [(tag,
    float32 scalar | (height, width, colorspace, png bytes))]}], every
    record's length and data CRC checked (masked CRC32C)."""
    import struct

    import numpy as np

    data, pos, events = open(path, "rb").read(), 0, []
    while pos < len(data):
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        body = data[pos + 12:pos + 12 + n]
        check(len(body) == n and pos + 16 + n <= len(data),
              f"{path}: truncated record at byte {pos}")
        check(struct.unpack("<I", data[pos + 8:pos + 12])[0] == masked_crc(head)
              and struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0]
              == masked_crc(body), f"{path}: bad CRC in the record at byte {pos}")
        pos += 16 + n
        ev = {"step": 0, "file_version": None, "values": []}
        for f, _, v in _pb_fields(body):
            if f == 2:
                ev["step"] = v
            elif f == 3:
                ev["file_version"] = v.decode()
            elif f == 5:
                for vf, _, val in _pb_fields(v):
                    if vf != 1:
                        continue
                    tag, item = None, None
                    for ff, _, x in _pb_fields(val):
                        if ff == 1:
                            tag = x.decode()
                        elif ff == 2:
                            item = np.frombuffer(x, "<f4")[0]
                        elif ff == 4:
                            im = {k: x2 for k, _, x2 in _pb_fields(x)}
                            item = (im.get(1, 0), im.get(2, 0), im.get(3, 0), im.get(4))
                    ev["values"].append((tag, item))
        events.append(ev)
    return events


def _lzw_decode(data: bytes, min_size: int, n: int) -> bytes:
    """GIF LZW → ``n`` indices (the decoder side: 12-bit cap, no early
    change)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, pos, prev = list(base), min_size + 1, 0, None
    out = bytearray()
    data = data + b"\x00\x00\x00"
    while len(out) < n:
        b = pos >> 3
        code = (int.from_bytes(data[b:b + 3], "little") >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table, size, prev = list(base), min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise PhaseError(f"GIF: code {code} past the table ({len(table)})")
        out += entry
        if len(table) == (1 << size) and size < 12:
            size += 1
        prev = entry
    check(len(out) == n, f"GIF: {len(out)} indices decoded, {n} expected")
    return bytes(out)


def read_gif(path, decode=True):
    """A GIF of full-size frames → (frames as (H, W, 3) uint8 through each
    frame's colour table, or None when ``decode`` is false; the delay of
    each frame; whether a NETSCAPE loop block is there)."""
    import struct

    import numpy as np

    d = open(path, "rb").read()
    check(d[:6] == b"GIF89a", f"{path}: not a GIF89a")
    W, H, flags = struct.unpack("<HHB", d[6:11])
    pos, gct = 13, None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(d[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames, delays, loop, delay = [], [], False, 0
    while True:
        b = d[pos]
        if b == 0x3B:
            break
        if b == 0x21:
            label, pos = d[pos + 1], pos + 2
            blocks = []
            while d[pos]:
                blocks.append(d[pos + 1:pos + 1 + d[pos]])
                pos += 1 + d[pos]
            pos += 1
            if label == 0xF9:
                delay = struct.unpack("<H", blocks[0][1:3])[0]
            elif label == 0xFF and blocks and blocks[0].startswith(b"NETSCAPE"):
                loop = True
            continue
        check(b == 0x2C, f"{path}: unknown block {b:#x} at byte {pos}")
        x, y, w, h, fl = struct.unpack("<HHHHB", d[pos + 1:pos + 10])
        check((x, y, w, h) == (0, 0, W, H), f"{path}: a partial frame")
        pos += 10
        ct = gct
        if fl & 0x80:
            n = 2 << (fl & 7)
            ct = np.frombuffer(d[pos:pos + 3 * n], np.uint8).reshape(n, 3)
            pos += 3 * n
        min_size, pos = d[pos], pos + 1
        parts = []
        while d[pos]:
            parts.append(d[pos + 1:pos + 1 + d[pos]])
            pos += 1 + d[pos]
        pos += 1
        if decode:
            idx = np.frombuffer(_lzw_decode(b"".join(parts), min_size, W * H), np.uint8)
            frames.append(ct[idx].reshape(H, W, 3))
        delays.append(delay)
        delay = 0
    return (frames if decode else None), delays, loop


def gif_psnr(a, b):
    import numpy as np
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def with_gamma(path, gamma=45455):
    """Insert a gAMA chunk after a PNG's IHDR (as ImageMagick writes one)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    g = struct.pack(">I", gamma)
    chunk = (struct.pack(">I", 4) + b"gAMA" + g
             + struct.pack(">I", zlib.crc32(b"gAMA" + g) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(data[:33] + chunk + data[33:])


FERN_H, FERN_W, FERN_VIEWS = 378, 504, 8      # fern's images_8: 4032x3024 / 8


def write_llff_scene(root):
    """A forward-facing LLFF scene at fern's ``images_8`` size: 8 views on
    a 4 x 2 grid in a plane, looking down -z, bounds 1.5-8 (fern's are
    about 1.3-11), colour fields that shift with the view; PNGs written by
    ``data/png.py`` with a gAMA chunk of 45455 each, and ``poses_bounds.npy``
    (nerf-pytorch's layout: [down, right, back] columns, hwf of the full
    4032 x 3024 frames). → the images as written."""
    import numpy as np

    from nerf_sandbox_tpu_torch.data.png import write_png

    os.makedirs(os.path.join(root, "images_8"), exist_ok=True)
    rows, images = [], []
    y, x = np.mgrid[0:FERN_H, 0:FERN_W].astype(np.float32)
    for i in range(FERN_VIEWS):
        cx, cy = 0.2 * (i % 4) - 0.3, 0.2 * (i // 4) - 0.1
        pose = np.zeros((3, 5), np.float32)
        pose[:, 0] = (0.0, -1.0, 0.0)                 # down
        pose[:, 1] = (1.0, 0.0, 0.0)                  # right
        pose[:, 2] = (0.0, 0.0, 1.0)                  # back
        pose[:, 3] = (cx, cy, 0.0)
        pose[:, 4] = (3024.0, 4032.0, 3260.0)
        rows.append(np.concatenate([pose.reshape(-1), [1.5, 8.0]]))
        sx, sy = x + 40 * cx, y + 40 * cy
        img = np.stack([0.5 + 0.4 * np.sin(sx / 31.0) * np.cos(sy / 23.0),
                        0.5 + 0.4 * np.cos((sx + sy) / 41.0),
                        0.5 + 0.4 * np.sin(np.hypot(sx - 250, sy - 190) / 19.0)], -1)
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        path = os.path.join(root, "images_8", f"IMG_{4026 + i}.png")
        write_png(path, img)
        with_gamma(path)
        images.append(img)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows).astype(np.float64))
    return images


JPEG_FIXTURE = os.path.join("tests", "golden", "fern_like_504x378.jpg")
# sha256 of imageio.v2.imread(JPEG_FIXTURE)'s bytes (Pillow 12.1, libjpeg-turbo)
JPEG_FIXTURE_SHA256 = "a729611f4f361760a4ae79662d35a6e9ac88e18029f5ce79a998fd03b965863a"
QS_STEPS, QS_FRAMES, QS_VALS, QS_LOG = 40, 4, 2, 10
FERN_STEPS = 40


def _logged_vs_events(tag, st, events, card):
    """The loop's logged loss, PSNR and lr at every log step against the
    event file's, as float32; → the scalars by (tag, step)."""
    import numpy as np

    scalars = {(t, ev["step"]): v for ev in events for t, v in ev["values"]
               if not isinstance(v, tuple)}
    mem = [int(scalars[("sys/hbm_bytes_in_use", s)]) for s, *_ in st["logged"]
           if ("sys/hbm_bytes_in_use", s) in scalars]
    bad = [(s, k) for s, loss, psnr, lr in st["logged"]
           for k, want in (("train/loss", loss), ("train/psnr", psnr), ("train/lr", lr))
           if scalars.get((k, s)) != np.float32(want)]
    print(f"[{tag}] event file: {len(events)} records, every CRC valid; "
          f"train/loss, train/psnr, train/lr at log steps "
          f"{[s for s, *_ in st['logged']]} equal to the trainer's as float32: "
          f"{not bad}; sys/hbm_bytes_in_use at them: "
          f"{mem} | {card}",
          flush=True)
    check(events and events[0]["file_version"] == "brain.Event:2",
          f"{tag}: the event file does not start with brain.Event:2")
    check(st["logged"] and not bad, f"{tag}: logged scalars differ from the events: {bad}")
    check(len(mem) == len(st["logged"]),
          f"{tag}: no sys/hbm_bytes_in_use at the log steps")
    return scalars


def _timed_codecs():
    """Wrap the TensorBoard logger's calls, the GIF writer and its LZW
    encoder to add up their seconds → (totals dict, undo)."""
    from nerf_sandbox_tpu_torch.render import gif as gif_mod
    from nerf_sandbox_tpu_torch.render import video as vid
    from nerf_sandbox_tpu_torch.utils.tb import TensorBoardLogger as TBL

    spent = {k: [0.0, 0] for k in ("tb_scalar", "tb_image", "tb_flush", "gif_rgb",
                                   "gif_gray", "lzw")}
    saved = [(TBL, "add_scalar"), (TBL, "add_image"), (TBL, "flush"), (vid, "write_gif"),
             (gif_mod, "lzw_codes")]
    orig = {name: getattr(obj, name) for obj, name in saved}

    def wrap(name, key_of):
        fn = orig[name]

        def timed(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            key, n = key_of(a)
            spent[key][0] += time.perf_counter() - t0
            spent[key][1] += n
            return r
        return timed

    TBL.add_scalar = wrap("add_scalar", lambda a: ("tb_scalar", 1))
    TBL.add_image = wrap("add_image", lambda a: ("tb_image", 1))
    TBL.flush = wrap("flush", lambda a: ("tb_flush", 1))
    vid.write_gif = wrap("write_gif", lambda a: (
        "gif_rgb" if a[1][0].ndim == 3 else "gif_gray", len(a[1])))
    gif_mod.lzw_codes = wrap("lzw_codes", lambda a: ("lzw", 1))

    def undo():
        for obj, name in saved:
            setattr(obj, name, orig[name])
    return spent, undo


def gif_of_rendered(frames, tmp, card):
    """GIF packing of rendered frames: phase 5's two 800x800 frames of the
    reference's trained 8x256 weights, rgb and opacity, each packed, timed
    and decoded back (gray bit-equal, RGB PSNR printed) → (s per RGB
    frame, s per gray frame)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.render.gif import write_gif
    from nerf_sandbox_tpu_torch.render.validation import to_uint8

    out = []
    for key in ("rgb", "acc"):
        imgs = [to_uint8(f[key]) for f in frames]
        path = os.path.join(tmp, f"rendered_{key}.gif")
        t0 = time.perf_counter()
        write_gif(path, imgs)
        out.append((time.perf_counter() - t0) / len(imgs))
        dec, _, _ = read_gif(path)
        if key == "rgb":
            psnrs = [gif_psnr(g, im) for g, im in zip(dec, imgs)]
            colours = [len(np.unique(im.reshape(-1, 3), axis=0)) for im in imgs]
        else:
            check(all(np.array_equal(g[..., 0], im) for g, im in zip(dec, imgs)),
                  "a rendered opacity frame's GIF differs from it")
    print(f"[qs] GIF packing of phase 5's rendered {IMG}x{IMG} frames (the reference's "
          f"trained weights, {colours} colours): {out[0]:.4f} s an RGB frame "
          f"(PSNR {', '.join(f'{x:.2f}' for x in psnrs)} dB against the frame), "
          f"{out[1]:.4f} s a gray one, bit-equal | {card}", flush=True)
    return out


def phase_quickstart(torch, card, figures, rendered):
    """11: the README's Quickstart commands through the port's CLI.

    11a, Blender: phase 9's scene with the README's flags (``--vanilla
    --use_tb --render_path_after --progress_video_during_training``), cut
    in steps (40), path frames (``--progress_frames 4``: 4 progress and 4
    path frames), validation events (2; the default 100 would make each of
    40 steps one) and the log interval (10). The event file, read by
    :func:`read_events` (every CRC checked), must hold the loop's loss, PSNR
    and lr as float32 at every log step, the card's memory, and each
    validation's images and PSNR / SSIM; the camera-path, progress and
    validation GIFs (:func:`read_gif`) one frame per PNG less merged
    duplicates, delay 0, no loop block, gray frames bit-equal to their
    PNGs and RGB frames at >= 30 dB; K2's launches the gate's prediction
    (TensorBoard and GIFs add none). 11b, fern: a synthetic LLFF scene at
    fern's ``images_8`` size with gAMA PNGs, through the README's fern
    flags (``--data_kind llff --downscale 8 --use_ndc --ndc_near_plane_world
    1.0 --vanilla --use_tb``), 40 steps, one validation: the loaded images
    must equal imageio's gamma formula computed here, the loss must fall;
    and the committed JPEG at that size decoded (sha256 of imageio's
    pixels) and timed; GIF packing timed on ``rendered``, phase 5's frames
    (:func:`gif_of_rendered`). → {kernel: launches} of 11a's window."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
    from nerf_sandbox_tpu_torch.data.llff_loader import LLFFSceneLoader
    from nerf_sandbox_tpu_torch.data.png import read_png
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_qs_")
    undo = None
    try:
        gif_real = gif_of_rendered(rendered, tmp, card)
        spent, undo = _timed_codecs()
        images, K, c2ws = bench_frames()
        data = os.path.join(tmp, "lego")
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        out = os.path.join(tmp, "exp", "lego_vanilla")
        argv = ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
                "--vanilla", "--use_tb", "--max_steps", str(QS_STEPS),
                "--render_path_after", "--progress_video_during_training",
                "--progress_frames", str(QS_FRAMES), "--num_val_steps", str(QS_VALS),
                "--log_every", str(QS_LOG)]
        torch.cuda.synchronize()
        fm.fused_nerf_apply.launches = 0
        fr.reset_launches()
        t0 = time.perf_counter()
        trainer = train_nerf(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2, routes, k1 = (fr.fused_raymarch.launches,
                          dict(fr.fused_raymarch.route_launches), fm.fused_nerf_apply.launches)
        st = trainer.run_stats
        want = k2_launches(8, 8) + 2 * QS_FRAMES * k2_launches(IMG, IMG)
        print(f"[qs blender] {' '.join(argv[6:])}: {st['steps']} steps, validations at "
              f"{trainer.val_steps}, {wall:.2f} s in main (loop {st['loop_s']:.2f} s, "
              f"validation {st['val_s']:.2f} s); K2 launches {k2} (routes {routes}), "
              f"gate's prediction {want} = probe 2 + {QS_FRAMES} progress + {QS_FRAMES} "
              f"path frames x {k2_launches(IMG, IMG)}; K1 {k1} | {card}", flush=True)
        check(k2 == want == routes["freq"] and k1 == 0,
              f"11a: K2 launched {k2} ({routes}), K1 {k1}; the gate predicts {want}")
        check(st["end_step"] == QS_STEPS, f"11a ended at step {st['end_step']}")

        (ev_file,) = [os.path.join(out, "tb", f) for f in os.listdir(os.path.join(out, "tb"))]
        check(os.path.basename(ev_file).startswith("events.out.tfevents."),
              f"11a: event file name {ev_file}")
        events = read_events(ev_file)
        scalars = _logged_vs_events("qs blender", st, events, card)
        images_tb = {(t, ev["step"]): v for ev in events for t, v in ev["values"]
                     if isinstance(v, tuple)}
        # the JAX logger's max side: int(800 * (512 / 800)) in float64
        side = int(IMG * (512 / IMG)) if IMG > 512 else IMG
        for vs in trainer.val_steps:
            for kind in ("rgb", "opacity", "depth"):
                item = images_tb.get((f"val/0/{kind}", vs))
                check(item is not None, f"11a: no val/0/{kind} image at step {vs}")
                png = read_png_bytes(item[3], tmp)
                check(png.shape[:2] == (item[0], item[1]) == (side, side)
                      and item[2] == 3, f"11a: val/0/{kind} is {png.shape}, {item[:3]}")
            for k in ("val/psnr_frame_0", "val/ssim_frame_0", "val/psnr_mean",
                      "val/ssim_mean"):
                check(np.isfinite(scalars.get((k, vs), np.nan)), f"11a: no {k} at {vs}")
        check(scalars[("val/psnr_mean", st["val"]["step"])]
              == np.float32(st["val"]["psnr_mean"]), "11a: val/psnr_mean differs")
        print(f"[qs blender] validation images val/0/{{rgb,opacity,depth}} at {side}x{side} "
              f"({IMG} -> {side}, INTER_AREA) and PSNR / SSIM at steps {trainer.val_steps}; "
              f"val/psnr_mean {float(scalars[('val/psnr_mean', st['val']['step'])]):.4f} dB",
              flush=True)

        vroot = os.path.join(out, "validation")
        gif_psnrs, n_gif = [], 0
        for folder, name, decode in (("camera_path", "camera_path", True),
                                     ("training_progress", "training_progress", True),
                                     ("val_idx0000", "val_idx0000", False)):
            for kind in ("rgb", "depth", "opacity"):
                pdir = os.path.join(vroot, folder, kind)
                pngs = [read_png(os.path.join(pdir, f)) for f in sorted(os.listdir(pdir))]
                kept = [im for i, im in enumerate(pngs)
                        if i == 0 or not np.array_equal(pngs[i - 1], im)]
                frames, delays, loop = read_gif(
                    os.path.join(vroot, folder, f"{name}_{kind}.gif"), decode)
                check(len(delays) == len(kept) and set(delays) == {0} and not loop,
                      f"11a: {name}_{kind}.gif has {len(delays)} frames (delays {delays}, "
                      f"loop {loop}), its {len(pngs)} PNGs give {len(kept)}")
                n_gif += len(delays)
                if not decode:
                    continue
                for g, im in zip(frames, kept):
                    if kind == "rgb":
                        gif_psnrs.append(gif_psnr(g, im))
                    else:
                        check(np.array_equal(g[..., 0], im),
                              f"11a: a gray frame of {name}_{kind}.gif differs from its PNG")
        print(f"[qs blender] GIFs: camera_path, training_progress and val_idx0000 x "
              f"{{rgb, depth, opacity}}, {n_gif} frames, one per PNG less merged "
              f"duplicates, delay 0, no loop block; gray frames bit-equal to their PNGs; "
              f"RGB PSNR against the PNGs {min(gif_psnrs):.2f}-{max(gif_psnrs):.2f} dB "
              f"(min 30)", flush=True)
        check(min(gif_psnrs) >= 30.0, f"11a: an RGB GIF frame at {min(gif_psnrs):.2f} dB")

        # ---- 11b, fern ----
        t_b = time.perf_counter()
        fern = os.path.join(tmp, "fern")
        raw = write_llff_scene(fern)
        names = sorted(os.listdir(os.path.join(fern, "images_8")))
        frames = (LLFFSceneLoader(fern, downscale=8).load("train").frames
                  + LLFFSceneLoader(fern, downscale=8).load("test").frames)
        same = len(frames) == FERN_VIEWS
        for f in frames:
            x = raw[names.index(f.meta["basename"])]
            want_img = np.round(((x / 255.0) ** 0.45455) * 255.0 * 1.0 + 0.4999)
            same = same and np.array_equal(
                f.image, want_img.astype(np.uint8).astype(np.float32) / 255.0)
        print(f"[qs fern] wrote {FERN_VIEWS} {FERN_W}x{FERN_H} gAMA PNGs (0.45455) and "
              f"poses_bounds.npy; the loader's {len(frames)} images (train and test) "
              f"equal round(((x/255)^0.45455)*255 + 0.4999)/255 computed here: {same}",
              flush=True)
        check(same, "11b: the gAMA images differ from imageio's gamma formula")
        fout = os.path.join(tmp, "exp", "fern_vanilla")
        fargv = ["--data_kind", "llff", "--data_root", fern, "--downscale", "8",
                 "--use_ndc", "--ndc_near_plane_world", "1.0", "--vanilla", "--use_tb",
                 "--out_dir", fout, "--max_steps", str(FERN_STEPS),
                 "--num_val_steps", "1", "--log_every", str(QS_LOG)]
        torch.cuda.synchronize()
        fr.reset_launches()
        t0 = time.perf_counter()
        ftr = train_nerf(fargv)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
        fk2 = fr.fused_raymarch.launches
        fst = ftr.run_stats
        losses = [v for _, v in fst["losses"]]
        first = float(fst["first_loss"])
        print(f"[qs fern] {' '.join(fargv[4:])}: {fst['steps']} steps in {fwall:.2f} s "
              f"in main, loss {first:.6f} at step 1 -> {losses} at "
              f"{[s for s, _ in fst['losses']]}; validation {ftr.scene_val.frames[0].W}x"
              f"{ftr.scene_val.frames[0].H} PSNR {fst['val']['psnr_mean']:.4f} dB; K2 "
              f"launches {fk2} (probe {k2_launches(8, 8)}) | {card}", flush=True)
        check(np.isfinite([first] + losses).all() and losses[-1] < first,
              f"11b: the fern loss did not fall: {first} -> {losses}")
        check(fk2 == k2_launches(8, 8), f"11b: K2 launched {fk2}, the probe makes 2")
        (fev,) = [os.path.join(fout, "tb", f) for f in os.listdir(os.path.join(fout, "tb"))]
        _logged_vs_events("qs fern", fst, read_events(fev), card)

        jpath = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_FIXTURE)
        t0 = time.perf_counter()
        for _ in range(3):
            jimg = read_jpeg(jpath)
        jpeg_s = (time.perf_counter() - t0) / 3
        jsha = hashlib.sha256(jimg.tobytes()).hexdigest()
        print(f"[qs fern] {JPEG_FIXTURE} ({jimg.shape[1]}x{jimg.shape[0]}, 4:2:0, "
              f"q90): {jpeg_s:.3f} s a frame on this host, pixels bit-equal to "
              f"imageio's (sha256): {jsha == JPEG_FIXTURE_SHA256}", flush=True)
        check(jsha == JPEG_FIXTURE_SHA256, "11b: the JPEG decodes unlike imageio")
        print(f"[qs fern] phase 11b took {time.perf_counter() - t_b:.2f} s", flush=True)

        per = {k: (v[0] / v[1] if v[1] else float("nan"), v[1]) for k, v in spent.items()}
        figures.update(tb_scalar_s=per["tb_scalar"][0], tb_image_s=per["tb_image"][0],
                       gif_rgb_s=per["gif_rgb"][0], gif_gray_s=per["gif_gray"][0],
                       lzw_s=per["lzw"][0], jpeg_s=jpeg_s, gif_real_rgb_s=gif_real[0],
                       gif_real_gray_s=gif_real[1])
        print(f"[qs] host cost over 11a + 11b: TensorBoard {per['tb_scalar'][1]} scalars "
              f"at {1e3 * per['tb_scalar'][0]:.3f} ms each, {per['tb_image'][1]} images "
              f"(downscale, PNG, CRC, write) at {1e3 * per['tb_image'][0]:.1f} ms each, "
              f"{per['tb_flush'][1]} flushes {1e3 * spent['tb_flush'][0]:.1f} ms in all; "
              f"GIF packing {per['gif_rgb'][1]} RGB {IMG}x{IMG} frames at "
              f"{per['gif_rgb'][0]:.3f} s each, {per['gif_gray'][1]} gray at "
              f"{per['gif_gray'][0]:.3f} s each, of which the LZW code loop "
              f"{per['lzw'][0]:.3f} s a frame ({per['lzw'][1]} frames written) | {card}",
              flush=True)
        print(f"[qs] phase 11 took {time.perf_counter() - t_phase:.2f} s", flush=True)
        return {"fused_raymarch": k2}
    finally:
        if undo is not None:
            undo()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 11c

JPEG_TAIL = os.path.join("tests", "golden", "jpeg_tail")
JPEG_STEPS = 30


def phase_jpeg_tail(torch, card):
    """11c, fern from JPEGs: every fixture of ``tests/golden/jpeg_tail``
    (written by ``tests/golden/gen_jpeg_tail.py``: ``write_llff_scene``'s
    eight 504x378 views, one JPEG kind each, and small CMYK, YCCK and
    lossless files) decoded by ``data/jpeg.py`` to the sha256, shape and
    dtype of imageio's array, each timed; each refused kind raising as
    imageio does; then the fern scene with those eight views as its
    ``images_8`` through the README's fern flags, ``JPEG_STEPS`` steps: the
    loss must fall and K2 launch only for the probe."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf

    t_phase = time.perf_counter()
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_TAIL)
    with open(os.path.join(here, "manifest.json")) as f:
        manifest = json.load(f)
    bad = []
    for name, want in manifest["decoded"].items():
        t0 = time.perf_counter()
        arr = read_jpeg(os.path.join(here, name))
        dt = time.perf_counter() - t0
        ok = (hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]
              and list(arr.shape) == want["shape"] and str(arr.dtype) == want["dtype"])
        bad += [] if ok else [name]
        print(f"[jpeg tail] {name}: {'x'.join(map(str, arr.shape))} {arr.dtype} in "
              f"{dt:.3f} s on this host, equal to imageio's (sha256): {ok}", flush=True)
    check(not bad, f"11c: {bad} decode unlike imageio")
    raised = {}
    for name in manifest["refused"]:
        try:
            read_jpeg(os.path.join(here, name))
            raised[name] = "decoded"
        except ValueError as e:
            raised[name] = "raised" if "refuses it too" in str(e) else str(e)
    print(f"[jpeg tail] the kinds imageio refuses raise: {raised}", flush=True)
    check(set(raised.values()) == {"raised"}, f"11c: refused kinds {raised}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_jpeg_")
    try:
        fern = os.path.join(tmp, "fern")
        write_llff_scene(fern)
        d8 = os.path.join(fern, "images_8")
        for png, view in zip(sorted(os.listdir(d8)), manifest["views"]):
            os.remove(os.path.join(d8, png))
            shutil.copy(os.path.join(here, view), os.path.join(d8, png[:-4] + ".jpg"))
        out = os.path.join(tmp, "exp", "fern_jpeg")
        argv = ["--data_kind", "llff", "--data_root", fern, "--downscale", "8",
                "--use_ndc", "--ndc_near_plane_world", "1.0", "--vanilla", "--use_tb",
                "--out_dir", out, "--max_steps", str(JPEG_STEPS), "--num_val_steps", "1",
                "--log_every", str(QS_LOG)]
        torch.cuda.synchronize()
        fr.reset_launches()
        t0 = time.perf_counter()
        trainer = train_nerf(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = fr.fused_raymarch.launches
        st = trainer.run_stats
        losses = [v for _, v in st["losses"]]
        first = float(st["first_loss"])
        print(f"[jpeg tail] fern from the 8 JPEG views ({', '.join(manifest['views'])}): "
              f"{' '.join(argv[4:])}: {st['steps']} steps in {wall:.2f} s in main, loss "
              f"{first:.6f} at step 1 -> {losses} at {[s for s, _ in st['losses']]}; K2 "
              f"launches {k2} (probe {k2_launches(8, 8)}) | {card}", flush=True)
        check(np.isfinite([first] + losses).all() and losses[-1] < first,
              f"11c: the fern loss did not fall: {first} -> {losses}")
        check(k2 == k2_launches(8, 8), f"11c: K2 launched {k2}, the probe makes 2")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[jpeg tail] phase 11c took {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"fused_raymarch": k2}


# ---------------------------------------------------------------- phase 12

SH_DEGREES = (4, 1, 2, 3)        # 12a: d = 4 and d = 1 are the kernels line's rows
APP_DIM = 16
S9_STEPS, S9_CKPT, S9_SCAN, S9_BARF = 132, 100, 16, 200
S9_CHUNK_BARF = 64               # 12c: the bands still ramp through the chunk


def sh_dirs(vd, d):
    """Per-ray SH encodings of degree ``d`` of unit view directions."""
    from nerf_sandbox_tpu_torch.core.encoding import encode_dirs
    return encode_dirs(vd, None, dir_encoder="sh", sh_degree=d)


def phase_slice9_tiles(torch, dev, card, t4, kernels):
    """12a: K2 at the direction widths and folded weights of slice 9, on
    phase 4's fine tile (16384 rays x 192 merged samples). Seeded 8x256
    models with SH directions at degrees 4, 1, 2 and 3 (16, 1, 4, 9 columns,
    each padded to 32) against K2's plain version, and an 8x256 model with
    16-wide appearance codes folded with a fixed code against the plain
    forward and composite of the UNFOLDED model fed that code on every ray:
    comp, w, acc 2e-2, depth held as Σw·z at 2e-2 x far (the seeded models
    are nearly transparent), the last-bin kink held apart; ERT (eps 1e-4)
    against none within 1e-3; each timed beside its bound and the frequency
    tile's time. Then, counted (the main path of 12a), each of the SH d = 4,
    SH d = 1 and folded models through ``render_rays_chunked`` on the tile's
    rays (a coarse and a fine K2 launch each, frequency route), and one
    ``nerf_forward_pass(use_kernel=True)`` through K1 on the SH d = 4 model
    and on the folded model; K1's raw rows at SH width against its plain
    version at phase 3's 0.05. → {kernels-line row: launches}."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP, fold_appearance
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_rays_chunked)

    t_phase = time.perf_counter()
    pos_bands, dir_bands = vanilla_encoders()
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
    freq_ms = kernels["fused_raymarch"]["ms"]

    def hold(tag, pk, enc_dir, plain_last, want=None):
        got = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
        if want is None:
            want = fr.fixup_outputs(*fr.fused_raymarch_plain(
                pk, ro, rd, z, dt, rn, enc_dir, pos_bands))
        want = tuple(w.reshape(g.shape) for w, g in zip(want, got))
        torch.cuda.synchronize()
        kink, bands = last_bin_kink([(fm.fused_nerf_apply(pk, enc_last, enc_dir)[:, 3],
                                      plain_last)])
        print(f"[{tag}] kink band |logit| < {bands[0]:.3g}", flush=True)
        err = hold_off_kink(tag, got, want, kink, depth_as_sum=True)
        ert = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands, ert_eps=1e-4)
        ert_errs = {n: max_diff(g, w) for n, g, w in zip(NAMES, ert, got)}
        for n in NAMES:
            check(np.isfinite(ert_errs[n]) and ert_errs[n] <= 1e-3,
                  f"{tag} ERT {n} max |diff| {ert_errs[n]} > 1e-3")
        ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                      pos_bands))
        ert_ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                          pos_bands, ert_eps=1e-4))
        plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
            pk, ro, rd, z, dt, rn, enc_dir, pos_bands), reps=3)
        ed = pk.cfg.enc_dir_dim
        b_ms, b_by = bound(2.0 * mlp_macs_per_row(pk.cfg) * B * N,
                           B * (7 + ed) * 4 + B * N * 4 * 3 + B * 5 * 4
                           + pk.flat.numel() * 2)
        print(f"[{tag}] fine tile {B}x{N} ({ed} direction columns, padded to "
              f"{fm._enc_pads(pk.cfg)[1]}): kernel {ms:.3f} ms ({ms / freq_ms:.3f}x "
              f"the 27-column tile's {freq_ms:.3f} ms), ERT(1e-4) {ert_ms:.3f} ms "
              f"(max|diff| vs none {max(ert_errs.values()):.3g}), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{100.0 * b_ms / ms:.1f}% of the bound) | {card}", flush=True)
        return dict(route="cuda", source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
                    replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None), got, kink

    sh_models = {}
    for d in SH_DEGREES:
        m = NeRFMLP(NeRFConfig(63, d * d, 8, 256, 4),
                    generator=torch.Generator().manual_seed(120 + d), device=dev)
        pk = fm.pack_nerf_params(m)
        ed = sh_dirs(vd, d)
        row, got, kink = hold(f"K2 SH d={d}", pk, ed,
                              fm.fused_nerf_apply_plain(pk, enc_last, ed)[:, 3])
        sh_models[d] = (m, got, kink)
        if d in (4, 1):
            kernels[f"fused_raymarch_sh{d}"] = dict(name=f"fused_raymarch_sh{d}", **row)

    gen = torch.Generator().manual_seed(127)
    m_app = NeRFMLP(NeRFConfig(63, 27, 8, 256, 4, app_dim=APP_DIM), generator=gen,
                    device=dev)
    code = (0.3 * torch.randn(APP_DIM, generator=gen)).to(dev)
    folded = fold_appearance(m_app, code)
    pk_app = fm.pack_nerf_params(folded)
    codes = code.expand(B, APP_DIM)
    ed27 = t4["enc_dir"]
    with torch.no_grad():
        want = nerf_forward_pass(m_app, ro, rd, z, pos_bands=pos_bands,
                                 dir_bands=dir_bands, white_bkgd=True, ray_norms=rn,
                                 viewdirs_world_unit=vd, infinite_last_bin=True,
                                 compute_dtype=torch.bfloat16, app_emb=codes,
                                 device=dev)
        plain_last = m_app(enc_last, ed27, compute_dtype=torch.bfloat16,
                           app=codes)[:, 3]
    row, got_app, kink_app = hold("K2 app folded", pk_app, ed27, plain_last, want)
    kernels["fused_raymarch_app"] = dict(name="fused_raymarch_app", **row)

    # K1's raw rows at the SH width, against its plain version (phase 3's 0.05)
    rng = np.random.RandomState(12)
    Q = EVAL_CHUNK * 64
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    dq = torch.from_numpy(rng.normal(size=(Q, 3)).astype(np.float32)).to(dev)
    eq = sh_dirs(dq / torch.linalg.vector_norm(dq, dim=-1, keepdim=True), 4)
    pk4 = fm.pack_nerf_params(sh_models[4][0])
    k1_err = max_diff(fm.fused_nerf_apply(pk4, ep, eq), fm.fused_nerf_apply_plain(pk4, ep, eq))
    print(f"[K1 SH d=4] Q={Q} max|diff| vs plain {k1_err:.3g} (tol 0.05)", flush=True)
    check(k1_err <= 0.05, f"K1 at SH width max |diff| {k1_err} > 0.05")

    # counted: the renderer's and the forward pass's paths
    launches = {}
    for tag, model, extra in (("fused_raymarch_sh4", sh_models[4][0],
                               dict(dir_encoder="sh", sh_degree=4)),
                              ("fused_raymarch_sh1", sh_models[1][0],
                               dict(dir_encoder="sh", sh_degree=1)),
                              ("fused_raymarch_app", folded, {})):
        tile = make_tile_renderer(EvalHyper(model=model.cfg, use_kernel=True, **extra),
                                  pos_bands, dir_bands, device=dev)
        torch.cuda.synchronize()
        fr.reset_launches()
        out = render_rays_chunked(tile, model, model, ro, rd, rn, vd,
                                  eval_chunk=EVAL_CHUNK, device=dev)
        torch.cuda.synchronize()
        routes = dict(fr.fused_raymarch.route_launches)
        check(fr.fused_raymarch.launches == routes["freq"] == 2,
              f"{tag}: render_rays_chunked launched K2 {fr.fused_raymarch.launches} "
              f"times ({routes}), expected 2 on the frequency route")
        for key in ("rgb", "acc", "depth"):
            check(bool(torch.isfinite(out[key]).all()), f"{tag} render {key} not finite")
        check(float(out["rgb"].min()) >= 0.0 and float(out["rgb"].max()) <= 1.0,
              f"{tag} render rgb outside [0, 1]")
        launches[tag] = routes["freq"]
    fwd_kw = dict(pos_bands=pos_bands, dir_bands=dir_bands, white_bkgd=True,
                  ray_norms=rn, viewdirs_world_unit=vd, infinite_last_bin=True,
                  compute_dtype=torch.bfloat16, use_kernel=True, device=dev)
    fm.fused_nerf_apply.launches = 0
    with torch.no_grad():
        fwd4 = nerf_forward_pass(sh_models[4][0], ro, rd, z, dir_encoder="sh",
                                 sh_degree=4, **fwd_kw)
        fwd_app = nerf_forward_pass(folded, ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    k1_launches = fm.fused_nerf_apply.launches
    check(k1_launches == 2, f"K1 launched {k1_launches} times in two forward passes")
    _, got4, kink4 = sh_models[4]
    e4 = max_diff(fwd4[0][~kink4], got4[0][~kink4])
    e_app = max_diff(fwd_app[0][~kink_app], want[0][~kink_app])
    print(f"[slice 9 tiles] counted: K2 {launches} (render_rays_chunked of {B} rays "
          f"each), K1 {k1_launches} (nerf_forward_pass, SH d=4 and folded); forward "
          f"pass vs K2 (SH d=4) comp max|diff| {e4:.3g}, folded forward through K1 "
          f"vs the unfolded model fed the code {e_app:.3g}, off the kink (tol 2e-2); "
          f"phase 12a took {time.perf_counter() - t_phase:.2f} s", flush=True)
    check(e4 <= 2e-2 and e_app <= 2e-2,
          f"K1 forward passes differ: SH {e4:.3g}, folded {e_app:.3g}")
    return launches


def unfolded_frame(torch, trainer, code, c2w, H, W, K):
    """The plain hierarchical render of the trainer's UNFOLDED models with
    ``code`` fed to every ray (``nerf_forward_pass(app_emb=...)`` in bf16,
    the renderer's tiling and sampling), and each ray's last-sample sigma
    logits of both models, kernel (K1 on the folded eval models) and plain
    (the unfolded ones fed the code). → (rgb (H, W, 3), kink (H, W), bands)."""
    from nerf_sandbox_tpu_torch.core.encoding import positional_encoding
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    eh, dev = trainer.eval_hyper, trainer.device
    mc, mf = trainer.state.model_c, trainer.state.model_f
    fc, ff = trainer.eval_models()
    rays = get_camera_rays_grid(torch.from_numpy(K).to(dev),
                                torch.from_numpy(c2w).to(dev), image_h=H, image_w=W,
                                convention=trainer.camera_convention, pixel_center=True)
    n, A = H * W, mf.cfg.app_dim
    kw = dict(pos_bands=trainer.pos_bands, dir_bands=trainer.dir_bands,
              white_bkgd=eh.white_bkgd, sigma_activation=eh.sigma_activation,
              infinite_last_bin=eh.infinite_last_bin, compute_dtype=torch.bfloat16,
              dir_encoder=eh.dir_encoder, sh_degree=eh.sh_degree, device=dev)
    rgb, pairs = [], [[], []]
    with torch.no_grad():
        for i in range(0, n, CLI_EVAL_CHUNK):
            s = slice(i, min(n, i + CLI_EVAL_CHUNK))
            ro, rd, rn, vd = (rays.o_march[s], rays.d_march_unit[s],
                              rays.d_march_norm[s], rays.d_world_unit[s])
            T = ro.shape[0]
            app = code.expand(T, A)
            zc = stratified_samples(eh.samp_near, eh.samp_far, eh.nc_eval,
                                    lindisp=eh.lindisp, device=dev).expand(T, eh.nc_eval)
            _, w_c, _, _ = nerf_forward_pass(mc, ro, rd, zc, ray_norms=rn,
                                             viewdirs_world_unit=vd, app_emb=app, **kw)
            zf = resample_midpoints(zc, w_c, eh.nf_eval, deterministic=True)
            comp, _, _, _ = nerf_forward_pass(mf, ro, rd, merge_z_samples(zc, zf),
                                              ray_norms=rn, viewdirs_world_unit=vd,
                                              app_emb=app, **kw)
            rgb.append(comp)
            enc_p = positional_encoding(ro + rd * (eh.samp_far * rn), trainer.pos_bands)
            enc_d = sh_dirs(vd, eh.sh_degree)
            for j, (folded, plain) in enumerate(((fc, mc), (ff, mf))):
                pairs[j].append((fm.fused_nerf_apply(folded, enc_p, enc_d)[:, 3],
                                 plain(enc_p, enc_d, compute_dtype=torch.bfloat16,
                                       app=app)[:, 3]))
    kink, bands = last_bin_kink([(torch.cat([a for a, _ in p]), torch.cat([b for _, b in p]))
                                 for p in pairs])
    return (torch.cat(rgb).reshape(H, W, 3).cpu().numpy(),
            kink.reshape(H, W).cpu().numpy(), bands)


def phase_slice9_cli(torch, card, figures):
    """12b: the CLI with slice 9's options on phase 9's scene (bench.py's 4
    frames at 800x800, 3 train): ``--vanilla --dir_enc sh --appearance_dim 16
    --pose_opt true --barf_anneal_steps 200 --max_steps 132 --ckpt_every 100
    --scan_steps 16``, one validation event (scored on the plain path) and
    one progress frame through K2. Checks: the dispatches JAX's rule gives
    (100 eager steps, then 2 chunks of 16, while BARF's bands still ramp);
    the loss falls; every row of ``app_emb`` and ``pose_delta`` moved from
    its initial value and is finite; the checkpoints at 100 and 132 hold
    both tables under JAX's keys; ``--resume latest`` from 100 to 132
    bit-equal to the straight run in the tables and the MLPs (else within
    the spread of a second straight run); K2's launches the gate's
    prediction, all on the frequency route. Then ``--render_only
    --eval_appearance 1`` with one 800x800 path frame through K2, held
    against the plain render of the unfolded models fed frame 1's code:
    max |Δrgb| <= 2e-2 off the last-bin kink and >= 40 dB."""
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import render_pose
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s9_")
    try:
        images, K, c2ws = bench_frames()
        data = os.path.join(tmp, "scene")
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})

        def base(out):
            return ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
                    "--vanilla", "--dir_enc", "sh", "--appearance_dim", str(APP_DIM),
                    "--pose_opt", "true", "--barf_anneal_steps", str(S9_BARF),
                    "--ckpt_every", str(S9_CKPT), "--scan_steps", str(S9_SCAN),
                    "--num_val_steps", "1", "--log_every", "100",
                    "--eval_chunk", str(CLI_EVAL_CHUNK)]

        def counted(argv):
            torch.cuda.synchronize()
            fm.fused_nerf_apply.launches = 0
            fr.reset_launches()
            t0 = time.perf_counter()
            trainer = train_nerf(argv)
            torch.cuda.synchronize()
            return (trainer, time.perf_counter() - t0, fr.fused_raymarch.launches,
                    dict(fr.fused_raymarch.route_launches))

        def tensors(trainer):
            return {k: p.detach().clone() for k, p in ts.named_params(trainer.state).items()}

        probe, per_frame = k2_launches(8, 8), k2_launches(IMG, IMG)
        out = os.path.join(tmp, "straight")
        trainer, wall, k2, routes = counted(
            base(out) + ["--max_steps", str(S9_STEPS), "--progress_video_during_training",
                         "--progress_frames", "1"])
        st = trainer.run_stats
        h = trainer.hyper
        check(h.dir_encoder == "sh" and h.model.enc_dir_dim == 16 and h.app_dim == APP_DIM
              and h.pose_opt and h.barf_anneal_steps == S9_BARF,
              f"the CLI did not build slice 9's step: {h}")
        check(trainer.eval_hyper.use_kernel and trainer.eval_hyper.model.app_dim == 0,
              "the kernel gate closed, or the eval model is not app-free")
        want_d = predicted_dispatches(1, S9_STEPS, S9_SCAN, 101, trainer.val_steps, S9_CKPT)
        loss1, loss_end = float(st["first_loss"]), st["losses"][-1][1]
        steps = st["steps"]
        cli_ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / steps
        init = ts.init_train_state(h, trainer.tx, near=trainer.near_world,
                                   far=trainer.far_world,
                                   generator=torch.Generator().manual_seed(
                                       int(trainer.cfg.seed)), device="cpu")
        moved = {}
        for name in ("app_emb", "pose_delta"):
            now = getattr(trainer.state.model_f, name).detach().cpu()
            was = getattr(init.model_f, name).detach()
            moved[name] = (bool(torch.isfinite(now).all()),
                           int((now != was).any(dim=1).sum()), now.shape[0],
                           float((now - was).abs().max()))
        print(f"[slice 9 cli] {steps} steps (--vanilla --dir_enc sh "
              f"--appearance_dim {APP_DIM} --pose_opt --barf_anneal_steps {S9_BARF}): "
              f"{wall:.2f} s in main, {cli_ms:.3f} ms/step through the CLI (phase 9's "
              f"vanilla {figures.get('cli_ms', float('nan')):.3f}); loss {loss1:.6f} "
              f"at step 1, {loss_end:.6f} at {st['end_step']}; dispatches "
              f"{dispatch_text(st['dispatches'], 1)} (JAX's rule: "
              f"{dispatch_text(want_d, 1)}); tables (finite, rows moved, rows, "
              f"max|move|): {moved} | {card}", flush=True)
        print(f"[slice 9 cli] K2 launches in the train window {k2} (routes {routes}), "
              f"gate's prediction {probe + per_frame} = probe {probe} + progress "
              f"frame {per_frame}", flush=True)
        check(st["dispatches"] == want_d == [1] * S9_CKPT + [S9_SCAN] * 2,
              f"dispatches {st['dispatches']} are not 100 eager steps and 2 chunks")
        check(np.isfinite(loss1) and np.isfinite(loss_end) and loss_end < loss1,
              f"the loss did not fall: {loss1} -> {loss_end}")
        check(all(f and n == rows for f, n, rows, _ in moved.values()),
              f"a table row did not move or is not finite: {moved}")
        check(k2 == probe + per_frame == routes["freq"],
              f"K2 launched {k2} times ({routes}), the gate predicts {probe + per_frame}")
        ck = os.path.join(out, "checkpoints")
        for s in (S9_CKPT, S9_STEPS):
            with np.load(os.path.join(ck, f"ckpt_{s:07d}.ckpt")) as zf:
                shapes = {k: zf[k].shape for k in ("params_f||['app_emb']",
                                                   "params_f||['pose_delta']")}
                last = {k: zf[k] for k in shapes} if s == S9_STEPS else None
            check(shapes == {"params_f||['app_emb']": (3, APP_DIM),
                             "params_f||['pose_delta']": (3, 6)},
                  f"checkpoint {s}: tables {shapes}")
        check(np.array_equal(last["params_f||['pose_delta']"],
                             trainer.state.model_f.pose_delta.detach().cpu().numpy()),
              "the step-132 checkpoint's pose table is not the state's")
        straight = tensors(trainer)

        # ---- resume from 100 to 132 ----
        out2 = os.path.join(tmp, "resumed")
        os.makedirs(os.path.join(out2, "checkpoints"))
        shutil.copy(os.path.join(ck, f"ckpt_{S9_CKPT:07d}.ckpt"),
                    os.path.join(out2, "checkpoints"))
        trainer2, wall2, _, _ = counted(base(out2) + ["--max_steps", str(S9_STEPS),
                                                      "--resume", "latest"])
        st2 = trainer2.run_stats
        eq, d = _bits_apart(list(straight.values()), list(tensors(trainer2).values()))
        spread = None
        if not eq:
            trainer3, _, _, _ = counted(base(os.path.join(tmp, "straight2"))
                                        + ["--max_steps", str(S9_STEPS)])
            _, spread = _bits_apart(list(straight.values()),
                                    list(tensors(trainer3).values()))
        apart = ("bit-equal" if eq else
                 f"max|diff| {d:.3g}, two straight runs differ by {spread:.3g}")
        print(f"[slice 9 cli] --resume latest {S9_CKPT} -> {S9_STEPS}: started at "
              f"{st2['start_step']}, dispatches "
              f"{dispatch_text(st2['dispatches'], st2['start_step'])}; tables and "
              f"MLPs against the straight run: {apart}; {wall2:.2f} s in main",
              flush=True)
        check(st2["start_step"] == S9_CKPT + 1 and st2["end_step"] == S9_STEPS,
              f"the resumed run ran {st2['start_step']}..{st2['end_step']}")
        check(eq or d <= spread, f"resume differs by {d:.3g} (spread {spread})")

        # ---- render_only --eval_appearance 1: one path frame through K2 ----
        trainer, wall, k2, routes = counted(
            base(out) + ["--max_steps", str(S9_STEPS), "--resume", "latest",
                         "--render_only", "--progress_frames", "1",
                         "--eval_appearance", "1"])
        ps = trainer.path_renderer.path_stats
        check(len(ps) == 1 and ps[0]["finite"], f"path frame missing: {ps}")
        check(k2 == probe + per_frame == routes["freq"],
              f"--render_only launched K2 {k2} times ({routes}), the gate predicts "
              f"{probe + per_frame}")
        valr = trainer.path_renderer
        H, W, Kp, c2w = valr._prog_H, valr._prog_W, valr._prog_K, valr._prog_poses[0]
        code = trainer.state.model_f.app_emb[1].detach()
        t0 = time.perf_counter()
        frame = render_pose(trainer.render_tile, *trainer.eval_models(), c2w, H, W, Kp,
                            eval_chunk=CLI_EVAL_CHUNK, device=trainer.device)
        torch.cuda.synchronize()
        k2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain, kink, bands = unfolded_frame(torch, trainer, code, c2w, H, W, Kp)
        plain_s = time.perf_counter() - t0
        drgb = np.abs(frame["rgb"] - plain).max(-1)
        d_rgb = float(drgb[~kink].max())
        psnr = compute_psnr(frame["rgb"], plain)
        print(f"[slice 9 cli] --render_only --eval_appearance 1: {ps[0]['seconds']:.3f} "
              f"s for the path frame, {wall:.2f} s in main, K2 launches {k2}; the frame "
              f"through K2 ({k2_s:.3f} s, frame 1's code folded) vs "
              f"the plain render of the unfolded models fed frame 1's code "
              f"({plain_s:.3f} s): max|drgb| {d_rgb:.3g} off the kink (tol 2e-2), "
              f"{int(kink.sum())} pixels at the kink (|logit| < {bands}), whole-frame "
              f"{float(drgb.max()):.3g}, PSNR {psnr:.2f} dB (min 40) | {card}", flush=True)
        check(kink.sum() <= 0.05 * kink.size, f"{int(kink.sum())} pixels at the kink")
        check(d_rgb <= 2e-2, f"folded K2 frame vs unfolded plain max |drgb| {d_rgb}")
        check(psnr >= 40.0, f"folded K2 frame vs unfolded plain PSNR {psnr:.2f} dB")
        figures["s9_cli_ms"] = cli_ms
        KEPT["s9"] = keep_run(data, out)
        print(f"[slice 9 cli] phase 12b took {time.perf_counter() - t_phase:.2f} s",
              flush=True)
        return {"fused_raymarch_app_cli": k2}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_slice9_chunk(torch, dev, card, figures):
    """12c: the captured chunk under BARF. Phase 8's recipe (bench.py's
    scene, 1024 rays, 8x256, 64 + 128, bf16) with SH directions (d = 4), 16-
    wide codes over the 4 frames, the pose table (``pose_lr`` 1e-3) and
    ``barf_anneal_steps`` 64, from its initial state: two runs of 16 eager
    steps bit-equal (or their spread printed), the captured chunk of 16
    (``build_train_step(scan_steps=16)``, one CUDA graph) bit-equal to them
    or within that spread, in every tensor of the state and the metrics,
    while the bands ramp (steps 1-16 of 64); then ms/step eager and in
    chunks beside phase 8's vanilla figures of this run."""
    from nerf_sandbox_tpu_torch.core.encoding import barf_band_weights, vanilla_encoders
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    k = TRAIN_SCAN
    scene = bench_scene(torch, dev)
    hyper = ts.TrainHyper(model=NeRFConfig(63, 16, 8, 256, 4, app_dim=APP_DIM), nc=64,
                          nf=128, raw_noise_std=1.0, sigma_activation="relu",
                          white_bkgd=True, infinite_last_bin=True, samp_near=2.0,
                          samp_far=6.0, app_dim=APP_DIM, n_app_frames=4,
                          dir_encoder="sh", sh_degree=4, pose_opt=True, n_pose_frames=4,
                          barf_anneal_steps=S9_CHUNK_BARF)
    spec = RayBatchSpec(rays_per_batch=TRAIN_RAYS, image_h=IMG, image_w=IMG,
                        white_bkgd=True)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 50_000, "eta_min": 5e-6},
                           pose_lr=1e-3)
    pos_b, dir_b = vanilla_encoders()
    chunk = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, scan_steps=k, device=dev)
    base = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                               generator=torch.Generator().manual_seed(9), device=dev)
    w = barf_band_weights(torch.tensor(k), S9_CHUNK_BARF, 10)
    keys = ("loss", "psnr", "mse_f", "finite", "loss_mean")

    def eager_run(st):
        losses = []
        for _ in range(k):
            st, m = chunk.step(st, scene)
            losses.append(m["loss"])
        return st, dict(m, loss_mean=(torch.stack(losses[:-1]).sum() + losses[-1]) / k)

    def flat(st, m):
        return ts.state_tensors(st) + [m[n] for n in keys]

    a, ma = eager_run(ts.clone_state(base))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b, mb = eager_run(ts.clone_state(base))
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / k
    eq_ee, d_ee = _bits_apart(flat(a, ma), flat(b, mb))
    g, mg = chunk(ts.clone_state(base), scene)
    torch.cuda.synchronize()
    mg = {n: t.clone() for n, t in mg.items()}
    eq_ge, d_ge = _bits_apart(flat(a, ma), flat(g, mg))
    moved = float(g.model_f.pose_delta.detach().abs().max())
    print(f"[slice 9 chunk] SH d=4 + codes + pose + BARF over {S9_CHUNK_BARF} steps "
          f"(band weights at step {k}: {[round(float(x), 4) for x in w]}): {k} eager "
          f"steps twice {'bit-equal' if eq_ee else f'spread max|diff| {d_ee:.3g}'}; "
          f"the captured chunk against them "
          f"{'bit-equal' if eq_ge else f'max|diff| {d_ge:.3g}'} (state and metrics); "
          f"pose table max|delta| {moved:.3g} after {k} steps", flush=True)
    check(chunk.captures == 1, f"the chunk captured {chunk.captures} graphs")
    check(eq_ge or (not eq_ee and d_ge <= d_ee),
          f"the captured chunk differs from {k} eager steps by {d_ge:.3g} (eager "
          f"spread {d_ee:.3g})")
    check(int(g.step) == k and bool(mg["finite"]) and moved > 0,
          f"chunk state: step {int(g.step)}, finite {bool(mg['finite'])}")
    g, _ = chunk(g, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CHUNKS):
        g, m = chunk(g, scene)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (TRAIN_CHUNKS * k)
    check(bool(m["finite"]) and chunk.captures == 1, "chunk losses not finite")
    figures.update(s9_eager_ms=eager_ms, s9_chunk_ms=chunk_ms)
    print(f"[slice 9 chunk] ms/step: eager {eager_ms:.3f} (phase 8 vanilla "
          f"{figures.get('train_ms', float('nan')):.3f}), in chunks of {k} "
          f"{chunk_ms:.3f} (phase 8 vanilla {figures.get('chunk_ms', float('nan')):.3f});"
          f" phase 12c took {time.perf_counter() - t_phase:.2f} s | {card}", flush=True)


# ---------------------------------------------------------------- phase 13

EVAL_REFINE_STEPS = 50          # 13a: --refine_pose and --refine_appearance steps
MESH_RES, MESH_CHECK_RES, MESH_FACES_32 = 128, 32, 4000
CHECK_STEPS, CHECK_RAYS, CHECK_SIDE = 20, 256, 100     # 13c
KEPT = {}          # phase tag -> (scene, run) copies that phase 13 reads
WORK_DIRS = []     # removed by main()


def keep_run(data, out):
    """Copies of a phase's scene and run directory that outlive the phase:
    phase 13 scores and meshes them. → (scene, run)."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    WORK_DIRS.append(d)
    shutil.copytree(data, os.path.join(d, "scene"))
    shutil.copytree(out, os.path.join(d, "run"), symlinks=True)
    return os.path.join(d, "scene"), os.path.join(d, "run")


def eval_kink(torch, trainer, c2w, H, W, K):
    """The last-bin kink of a frame through the trainer's folded eval models:
    each pixel's last-sample (z = far) sigma logits of the coarse and fine
    models through K1 against their plain bf16 forward (``last_bin_kink``).
    → (kink (H, W) bool array, bands)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import encode_dirs, positional_encoding
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    eh, dev = trainer.eval_hyper, trainer.device
    rays = get_camera_rays_grid(torch.from_numpy(np.asarray(K, np.float32)).to(dev),
                                torch.from_numpy(np.asarray(c2w, np.float32)).to(dev),
                                image_h=H, image_w=W, convention=trainer.camera_convention,
                                pixel_center=True)
    with torch.no_grad():
        enc_p = positional_encoding(rays.o_march + rays.d_march_unit
                                    * (eh.samp_far * rays.d_march_norm), trainer.pos_bands)
        enc_d = encode_dirs(rays.d_world_unit, trainer.dir_bands,
                            dir_encoder=eh.dir_encoder, sh_degree=eh.sh_degree)
        pairs = [(fm.fused_nerf_apply(m, enc_p, enc_d)[:, 3],
                  m(enc_p, enc_d, compute_dtype=torch.bfloat16)[:, 3])
                 for m in trainer.eval_models()]
    kink, bands = last_bin_kink(pairs)
    return kink.reshape(H, W).cpu().numpy(), bands


def phase_eval(torch, dev, card, t4, kernels):
    """13: held-out evaluation, the test-time refiners and the mesh export.

    13a, the eval CLI through K2: phase 12b's run (the 800x800 scene trained
    with ``--vanilla --dir_enc sh --appearance_dim 16 --pose_opt true``) with
    a 2-frame ``test`` split (frame 3 and a fifth pose, written by
    ``data/png.py``), ``eval_nerf --split test --val_exact false
    --refine_pose 50 --refine_appearance 50 --use_tb``: metrics.json's
    fields, K2's launches = 2 x ``k2_launches(800, 800)`` all on the
    frequency route and no K1 launch (the refiners are plain), the triplets
    written, ``run_debug.json`` byte-unchanged and no ``tb/``; seconds per
    frame, refine and render. Then K2 on phase 4's fine tile with the run's
    folded eval model against its plain version (the kernels line's
    ``fused_raymarch_eval`` row; its launches are 13a's).

    13b, K2 against plain: frame 0 scored at ``--res_scale 0.5`` under
    ``--val_exact false`` (K2) and under the default (plain); the two
    renders held at phase 12b's gates (max |Δrgb| <= 2e-2 off the last-bin
    kink, >= 40 dB).

    13c, the refiners on the card against the CPU: a seeded 8x256 model
    with 16-wide codes (fp32), a 100x100 frame it renders itself, the same
    injected draws, 20 steps of 256 rays. The code end to end within 1e-3
    of its move, mse_init / mse_final within 1e-3 relative. The pose
    refiner's final delta is chaotic on such a model (weights moved by 1e-7
    relative move it by 50-100% on the CPU), so it is held step by step:
    the card's gradient at each of the card's iterates against the CPU's at
    the same iterate, within 1e-2 of its largest entry, and mse_init within
    1e-4 relative. The gradient runs through the 10 bands' sin and cos, so
    sample positions one rounding apart (the card's FMAs) move it by up to
    ~3e-3 of its largest entry: each step's CPU gradient is also taken with
    the jitter scaled by 1 + 1.2e-7·N(0, 1), and that spread is printed
    beside the card's difference. ms per refine step on the card.

    13d, ``--render_only --export_mesh true --mesh_res 128`` on phase 9's
    vanilla run (one path frame through K2). A model trained on noise has
    no set surface level, and at the 90th percentile of its σ the 256³
    surface held 20.6 M faces, whose OBJ took most of 185 s: ``--mesh_thr``
    is the lowest of σ's 90th, 99th, 99.9th and 99.99th percentiles at res
    32 whose res-32 surface has at most ``MESH_FACES_32`` faces. The OBJ
    exists and has faces; the sweep's seconds (to the host copy), the
    isosurfacer's and the OBJ writer's host seconds; the σ grid at res 32 on
    the card against the CPU's, fp32 within 1e-4 and bf16 within 2e-2 of the
    grid's largest σ. → {kernels-line row: launches}."""
    import copy

    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import positional_encoding
    from nerf_sandbox_tpu_torch.core.pose import apply_cam_delta
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP, fold_appearance
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render import app_refine, mesh, pose_refine
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr, scale_hwk
    from nerf_sandbox_tpu_torch.scripts.eval_nerf import run as eval_nerf
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf

    t_phase = time.perf_counter()

    def counted(fn, argv):
        torch.cuda.synchronize()
        fm.fused_nerf_apply.launches = 0
        fr.reset_launches()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, fr.fused_raymarch.launches,
                dict(fr.fused_raymarch.route_launches), fm.fused_nerf_apply.launches)

    # ---- 13a: eval_nerf through K2, with both refiners ----
    data, run = KEPT["s9"]
    images, K, c2ws = bench_frames()
    img4 = np.random.RandomState(13).randint(0, 255, (IMG, IMG, 4), np.uint8)
    write_blender_scene(data, images + [img4], K, c2ws + [blender_pose(4)],
                        {"test": [3, 4]})
    dbg_path = os.path.join(run, "run_debug.json")
    with open(dbg_path, "rb") as f:
        dbg = f.read()
    out = os.path.join(run, "eval_test")
    argv = ["--data_root", data, "--out_dir", run, "--split", "test",
            "--val_exact", "false", "--refine_pose", str(EVAL_REFINE_STEPS),
            "--refine_appearance", str(EVAL_REFINE_STEPS), "--use_tb"]
    tr, wall, k2, routes, k1 = counted(eval_nerf, argv)
    m = tr.eval_metrics
    with open(os.path.join(out, "metrics.json")) as f:
        on_disk = json.load(f)
    want = 2 * k2_launches(IMG, IMG)
    stats = tr.eval_renderer.eval_stats
    print(f"[eval] eval_nerf --split test --val_exact false --refine_pose "
          f"{EVAL_REFINE_STEPS} --refine_appearance {EVAL_REFINE_STEPS} on phase "
          f"12b's run: {wall:.2f} s in main; per frame (refine s, render s): "
          f"{[(round(x['refine_s'], 3), round(x['render_s'], 3)) for x in stats]}; "
          f"K2 launches {k2} (routes {routes}), predicted 2 x {k2_launches(IMG, IMG)} "
          f"= {want}; K1 launches {k1} | {card}", flush=True)
    for f in m["frames"]:
        print(f"[eval] frame {f['index']}: psnr (right half) {f['psnr']:.3f} dB, "
              f"full {f['psnr_full_refined']:.3f} dB, ssim {f['ssim']:.4f}; pose "
              f"{f['pose_refine']}; appearance {f['app_refine']}", flush=True)
    print(f"[eval] split: psnr_mean {m['psnr_mean']:.4f} dB, ssim_mean "
          f"{m['ssim_mean']:.5f}, psnr_full_refined_mean "
          f"{m['psnr_full_refined_mean']:.4f} dB", flush=True)
    check(tr.eval_hyper_scored.use_kernel and tr.eval_only,
          "eval_nerf --val_exact false did not score through K2")
    check(k2 == want == routes["freq"] and k1 == 0,
          f"K2 launched {k2} times ({routes}), predicted {want}; K1 {k1}")
    check(on_disk == json.loads(json.dumps(m)) and m["split"] == "test"
          and m["n_frames"] == 2 and m["appearance_refined"] and m["step"] == S9_STEPS,
          f"metrics.json: { {k: v for k, v in m.items() if k != 'frames'} }")
    for f in m["frames"]:
        nums = [f["psnr"], f["ssim"], f["psnr_full_refined"],
                *f["pose_refine"].values(), *f["app_refine"].values()]
        check(all(np.isfinite(x) for x in nums) and f["psnr"] == f["psnr_heldout_half"],
              f"frame record {f}")
    for sub in ("rgb", "opacity", "depth"):
        got = sorted(os.listdir(os.path.join(out, sub)))
        check(got == ["frame_0000.png", "frame_0001.png"], f"{sub} triplets: {got}")
    with open(dbg_path, "rb") as f:
        check(f.read() == dbg, "eval_nerf rewrote run_debug.json")
    check(not os.path.exists(os.path.join(run, "tb")), "eval_nerf created tb/")

    # K2 on phase 4's fine tile with the run's folded eval model
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))
    B, N = z.shape
    pk = fm.pack_nerf_params(tr.eval_models()[1])
    ed = sh_dirs(vd, tr.eval_hyper.sh_degree)
    dt = fr._deltas(z, rn, True)
    got = fr.fused_raymarch(pk, ro, rd, z, rn, ed, tr.pos_bands)
    plain = fr.fixup_outputs(*fr.fused_raymarch_plain(pk, ro, rd, z, dt, rn, ed,
                                                      tr.pos_bands))
    plain = tuple(w.reshape(g.shape) for w, g in zip(plain, got))
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), tr.pos_bands)
    kink, bands = last_bin_kink([(fm.fused_nerf_apply(pk, enc_last, ed)[:, 3],
                                  fm.fused_nerf_apply_plain(pk, enc_last, ed)[:, 3])])
    err = hold_off_kink("K2 eval model", got, plain, kink, depth_as_sum=True)
    ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, ed, tr.pos_bands))
    plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        pk, ro, rd, z, dt, rn, ed, tr.pos_bands), reps=3)
    b_ms, b_by = bound(2.0 * mlp_macs_per_row(pk.cfg) * B * N,
                       B * (7 + pk.cfg.enc_dir_dim) * 4 + B * N * 4 * 3 + B * 5 * 4
                       + pk.flat.numel() * 2)
    kernels["fused_raymarch_eval"] = dict(
        name="fused_raymarch_eval", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[eval] K2 fine tile {B}x{N} with the run's folded eval model (SH d = "
          f"{tr.eval_hyper.sh_degree}, kink band {bands}): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) | {card}", flush=True)

    # ---- 13b: frame 0 scored through K2 and through the plain tile ----
    base = ["--data_root", data, "--out_dir", run, "--split", "test", "--indices", "0",
            "--res_scale", "0.5", "--no_images"]
    tr_k, wall_k, k2_b, _, _ = counted(eval_nerf, base + [
        "--val_exact", "false", "--eval_out", os.path.join(run, "eval_k2")])
    tr_p, wall_p, k2_p, _, _ = counted(eval_nerf, base + [
        "--eval_out", os.path.join(run, "eval_plain")])
    check(tr_k.eval_hyper_scored.use_kernel and not tr_p.eval_hyper_scored.use_kernel
          and k2_b == k2_launches(IMG // 2, IMG // 2) and k2_p == 0,
          f"13b: K2 launches {k2_b} (K2 run), {k2_p} (plain run)")
    fr0 = tr_k.scene_val.frames[0]
    H, W, Kh = scale_hwk(fr0.H, fr0.W, np.asarray(fr0.K, np.float32), 0.5)
    rk = tr_k.eval_renderer._render_pose(*tr_k.eval_models(), fr0.c2w, H, W, Kh,
                                         scored=True)
    rp = tr_p.eval_renderer._render_pose(*tr_p.eval_models(), fr0.c2w, H, W, Kh,
                                         scored=True)
    kink, bands = eval_kink(torch, tr_k, fr0.c2w, H, W, Kh)
    drgb = np.abs(rk["rgb"] - rp["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(rk["rgb"], rp["rgb"])
    fk, fp = tr_k.eval_metrics["frames"][0], tr_p.eval_metrics["frames"][0]
    print(f"[eval] frame 0 at {W}x{H} scored through K2 ({wall_k:.2f} s in main, "
          f"psnr {fk['psnr']:.4f} dB, ssim {fk['ssim']:.5f}) and through the plain "
          f"tile ({wall_p:.2f} s, psnr {fp['psnr']:.4f} dB, ssim {fp['ssim']:.5f}): "
          f"max|drgb| {d_rgb:.3g} off the kink (tol 2e-2), {int(kink.sum())} pixels "
          f"at the kink (|logit| < {bands}), whole-frame {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40) | {card}", flush=True)
    check(kink.sum() <= 0.05 * kink.size, f"13b: {int(kink.sum())} pixels at the kink")
    check(d_rgb <= 2e-2 and psnr >= 40.0,
          f"13b: K2 vs plain max|drgb| {d_rgb:.3g}, PSNR {psnr:.2f} dB")

    # ---- 13c: the refiners on the card against the CPU ----
    pos_b, dir_b = tr.pos_bands, tr.dir_bands
    cfg = NeRFConfig(63, 27, 8, 256, 4, app_dim=APP_DIM)
    devs = {"cpu": torch.device("cpu"), "card": dev}
    raw = {d: NeRFMLP(cfg, generator=torch.Generator().manual_seed(131), device=v,
                      initial_acc_opacity=0.5, sigma_activation="relu")
           for d, v in devs.items()}
    code = 0.3 * torch.randn(APP_DIM, generator=torch.Generator().manual_seed(5))
    folded = {d: fold_appearance(mdl, code) for d, mdl in raw.items()}
    hyper = EvalHyper(model=cfg._replace(app_dim=0), compute_dtype="float32")
    side = CHECK_SIDE
    Ks = np.array([[FOCAL * side / IMG, 0, side / 2], [0, FOCAL * side / IMG, side / 2],
                   [0, 0, 1]], np.float32)
    true = blender_pose(1)[:3, :4]
    bad = apply_cam_delta(torch.from_numpy(true),
                          torch.tensor([0.01, -0.02, 0.015, 0.05, -0.03, 0.02])).numpy()
    tile = make_tile_renderer(hyper, pos_b, dir_b, device=dev)
    gt = render_pose(tile, folded["card"], folded["card"], true, side, side, Ks,
                     eval_chunk=EVAL_CHUNK, device=dev)["rgb"]
    pdraws = pose_refine.refine_draws(CHECK_STEPS, CHECK_RAYS, hyper.nc_eval, side, side,
                                      0, "cpu")
    adraws = pose_refine.refine_draws(CHECK_STEPS, CHECK_RAYS, hyper.nc_eval, side // 2,
                                      side, 1, "cpu")
    res, secs = {}, {}
    for d, v in devs.items():
        pr = pose_refine.make_pose_refiner(hyper, pos_b, dir_b, device=v)
        ar = app_refine.make_appearance_refiner(hyper, pos_b, dir_b, model_cfg=cfg,
                                                model_f_raw=raw[d], code0=np.zeros(APP_DIM),
                                                device=v)
        kw = dict(steps=CHECK_STEPS, rays=CHECK_RAYS)
        for _ in range(2 if d == "card" else 1):       # the card's second run is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, pinfo = pr(folded[d], bad, Ks, side, side, gt, lr=5e-3, draws=pdraws, **kw)
            t1 = time.perf_counter()
            _, ainfo = ar(true, Ks, side, side, gt, lr=1e-2, draws=adraws, **kw)
            t2 = time.perf_counter()
        res[d], secs[d] = (pinfo, ainfo), (t1 - t0, t2 - t1)
    (pc, ac), (pg, ag) = res["cpu"], res["card"]
    move = float(np.abs(ac["code"]).max())
    d_code = float(np.abs(ag["code"] - ac["code"]).max())
    rel = {k: abs(ag[k] / ac[k] - 1.0) for k in ("mse_init", "mse_final")}
    rel_p = abs(pg["mse_init"] / pc["mse_init"] - 1.0)
    # the pose refiner step by step at the card's iterates
    ct = {d: pose_refine.frame_tensors(bad, Ks, gt, v) for d, v in devs.items()}
    dr = {d: pose_refine.as_draws(pdraws, v) for d, v in devs.items()}
    delta = torch.zeros(6, device=dev)
    adam = pose_refine.CosineAdam(delta, 5e-3, CHECK_STEPS)
    g_err, g_spread = [], []

    def pose_grad(d, x0, u):
        x = x0.detach().to(devs[d]).requires_grad_(True)
        c2w_d, K_d, gt_d = ct[d]
        obj = pose_refine.photometric_mse(
            folded[d], hyper, pos_b, dir_b, apply_cam_delta(c2w_d, x), K_d, side, side,
            gt_d, dr[d]["xs"][i], dr[d]["ys"][i], u, use_ndc=False, convention="opengl",
            near_plane=1.0, device=devs[d]) + 0.1 * torch.sum(x ** 2)
        return torch.autograd.grad(obj, [x])[0].cpu()

    for i in range(CHECK_STEPS):
        gd, gc = pose_grad("card", delta, dr["card"]["u"][i]), pose_grad(
            "cpu", delta, dr["cpu"]["u"][i])
        u_j = dr["cpu"]["u"][i] * (1.0 + 1.2e-7 * torch.randn(
            dr["cpu"]["u"][i].shape, generator=torch.Generator().manual_seed(i)))
        scale = gc.abs().max()
        g_err.append(float((gd - gc).abs().max() / scale))
        g_spread.append(float((pose_grad("cpu", delta, u_j) - gc).abs().max() / scale))
        delta = adam.step(delta, gd.to(dev))
    walk_eq = bool(torch.equal(delta.cpu(), torch.from_numpy(pg["delta"])))
    print(f"[refine] 13c, 8x256 seeded fp32, {side}x{side} frame, {CHECK_STEPS} steps "
          f"of {CHECK_RAYS} rays x {hyper.nc_eval} samples, same draws: code card vs "
          f"CPU max|diff| {d_code:.3g} of a {move:.3g} move (tol 1e-3 of it), mse "
          f"rel diffs {rel}; pose: gradient at each of the card's iterates, card vs "
          f"CPU, max|diff| / max|g| per step {[float(f'{e:.2g}') for e in g_err]} "
          f"(tol 1e-2; the CPU's own under ulp jitter of the samples "
          f"{[float(f'{e:.2g}') for e in g_spread]}), mse_init rel diff {rel_p:.3g} (tol 1e-4), the walk's final "
          f"delta {'bit-equal to' if walk_eq else 'differs from'} the card's refine; "
          f"final delta card {pg['delta']}, CPU {pc['delta']} (chaotic, not held)",
          flush=True)
    print(f"[refine] ms per refine step on the card: pose "
          f"{1e3 * secs['card'][0] / CHECK_STEPS:.3f}, appearance "
          f"{1e3 * secs['card'][1] / CHECK_STEPS:.3f} (CPU: {1e3 * secs['cpu'][0] / CHECK_STEPS:.1f}, "
          f"{1e3 * secs['cpu'][1] / CHECK_STEPS:.1f}); 13a's refiners at 1024 rays x "
          f"64 samples: {[round(x['refine_s'], 3) for x in stats]} s a frame for "
          f"2 x {EVAL_REFINE_STEPS} steps | {card}", flush=True)
    check(d_code <= 1e-3 * move and max(rel.values()) <= 1e-3,
          f"13c: code card vs CPU {d_code:.3g} (move {move:.3g}), mse {rel}")
    check(max(g_err) <= 1e-2 and rel_p <= 1e-4,
          f"13c: pose gradients card vs CPU {g_err}, mse_init {rel_p:.3g}")

    # ---- 13d: --render_only --export_mesh on phase 9's run ----
    data9, run9 = KEPT["cli"]
    tr9 = train_nerf(["--data_kind", "blender", "--data_root", data9, "--out_dir", run9,
                      "--vanilla", "--eval_chunk", str(CLI_EVAL_CHUNK), "--max_steps",
                      str(CLI_RESUME_STEPS), "--resume", "latest", "--render_only",
                      "--progress_frames", "1"])
    lo, hi = tr9.mesh_box()
    model9 = tr9.state.model_f
    model9_cpu = copy.deepcopy(model9).to("cpu")
    errs, grids = {}, {}
    for tag, ct_ in (("fp32", None), ("bf16", torch.bfloat16)):
        kw = dict(res=MESH_CHECK_RES, lo=lo, hi=hi, compute_dtype=ct_,
                  sigma_activation=tr9.cfg.sigma_activation)
        g_dev = mesh.query_density_grid(model9, tr9.pos_bands, tr9.dir_bands, device=dev,
                                        **kw)
        g_cpu = mesh.query_density_grid(model9_cpu, tr9.pos_bands, tr9.dir_bands,
                                        device="cpu", **kw)
        grids[tag] = g_dev
        errs[tag] = float(np.abs(g_dev - g_cpu).max() / max(np.abs(g_cpu).max(), 1e-30))
    for q in (0.9, 0.99, 0.999, 0.9999):
        thr = float(np.quantile(grids["bf16"], q))
        n32 = len(mesh.marching_tetrahedra(grids["bf16"], thr, lo, hi)[1])
        if 0 < n32 <= MESH_FACES_32:
            break
    argv9 = ["--data_kind", "blender", "--data_root", data9, "--out_dir", run9,
             "--vanilla", "--eval_chunk", str(CLI_EVAL_CHUNK), "--max_steps",
             str(CLI_RESUME_STEPS), "--resume", "latest", "--render_only",
             "--progress_frames", "1", "--export_mesh", "true", "--mesh_res",
             str(MESH_RES), "--mesh_thr", f"{thr:.6g}"]
    tr9, wall9, k2_9, routes9, _ = counted(train_nerf, argv9)
    ms9 = tr9.mesh_stats
    obj = os.path.join(run9, "mesh", f"mesh_step_{CLI_RESUME_STEPS:07d}.obj")
    want9 = k2_launches(8, 8) + k2_launches(IMG, IMG)
    print(f"[mesh] --render_only --export_mesh --mesh_res {MESH_RES} --mesh_thr "
          f"{thr:.6g} (σ's {100 * q:g}th percentile at {MESH_CHECK_RES}^3, {n32} faces "
          f"there) on phase 9's run (box {lo}..{hi}): {wall9:.2f} s in main; the "
          f"sweep {ms9[0]['sweep_s']:.3f} s ({MESH_RES ** 3} points, to the host copy), "
          f"the isosurfacer {ms9[0]['surface_s']:.3f} s and the OBJ writer "
          f"{ms9[0]['write_s']:.3f} s on the host; "
          f"{ms9[0]['verts']} verts, {ms9[0]['faces']} faces; K2 launches {k2_9} "
          f"(routes {routes9}), predicted {want9} | {card}", flush=True)
    print(f"[mesh] σ at {MESH_CHECK_RES}^3, card vs CPU: max|diff| / max σ {errs} "
          f"(tol fp32 1e-4, bf16 2e-2)", flush=True)
    check(os.path.exists(obj) and ms9[0]["faces"] > 0, f"13d: OBJ {obj}: {ms9}")
    with open(obj) as f:
        check(f.readline().startswith("# nerf-sandbox-tpu mesh:"), "13d: OBJ header")
    check(k2_9 == want9 == routes9["freq"], f"13d: K2 {k2_9} ({routes9}), want {want9}")
    check(errs["fp32"] <= 1e-4 and errs["bf16"] <= 2e-2, f"13d: σ grids {errs}")
    print(f"[eval] phase 13 took {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"fused_raymarch_eval": k2}


# ---- 14: --encoder hashgrid ----

HASH_STEPS, HASH_RESUME, HASH_CKPT = 116, 132, 100
HASH_OCC_STEPS, HASH_OCC_SCAN = 32, 8
HASH_MESH_RES = 128
HASH_REFINE_RAYS = 256


def hash_scatter_bytes(n, F, n_rows):
    """Bytes the table-gradient scatter must move: n int32 keys and n x F
    fp32 values read once, the (n_rows, F) fp32 table written once."""
    return n * 4 + n * F * 4 + n_rows * F * 4


def phase_hash_encode(torch, dev, card, kernels):
    """14a: the hash encode and the table-gradient scatter at the CLI's
    default widths (16 levels x 2^19 rows x 2 features, resolutions 16 to
    512, aabb 1.5), tables U(-1, 1) (features of order 1), points U(-1.6,
    1.6)^3 from a seed. The encode on the card against the CPU at 65,536
    and 196,608 points (a vanilla step's coarse and fine passes), max |diff|
    within 2e-4 (the card divides by the box as a product with its
    reciprocal, which moves the finest level's fractions by up to ~3e-5).
    The scatter (``ops/hash_scatter.py``) on the fine pass's 25.2 M (row,
    value) pairs, values N(0, 1) made on the card, for the points above
    (typical), for 196,608 points in a ball of radius 0.01 (every pair of
    a coarse level on 8 rows) and for 196,608 points beyond one corner of
    the box (clamped onto it: every level's pairs on 8 rows, runs of
    196,608, each one sum warp's walk): bit-equal to the plain version
    on CPU copies of the same tensors and across two card runs;
    ``index_add_`` on the card
    (atomics) beside it, and whether two of its runs agree. Timed: the
    encode's forward and backward at 196,608 points, the scatter and its
    parts (count, scan, partition and sum by the profiler in a process of
    its own: ``scatter_parts_ms``) beside its bound and ``index_add_``."""
    import numpy as np

    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs

    t_phase = time.perf_counter()
    parts_proc = start_scatter_parts()
    cfg = hg.HashGridConfig(aabb_scale=1.5)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    rng = np.random.RandomState(14)
    tables_np = rng.uniform(-1.0, 1.0, (L, T, F)).astype(np.float32)
    tab = {"cpu": torch.from_numpy(tables_np)}
    tab["card"] = tab["cpu"].to(dev)
    errs, pts = {}, {}
    for Q in (65536, 196608):
        p = torch.from_numpy(rng.uniform(-1.6, 1.6, (Q, 3)).astype(np.float32))
        pts[Q] = p.to(dev)
        with torch.no_grad():
            got = hg.hash_encode(tab["card"], pts[Q], cfg)
            want = hg.hash_encode(tab["cpu"], p, cfg)
        check(bool(torch.isfinite(got).all()) and got.shape == (Q, cfg.out_dim),
              f"14a: encode at {Q} points not finite or misshaped")
        errs[Q] = max_diff(got.cpu(), want)
    print(f"[hash] 14a encode, {L} levels x 2^{cfg.log2_table_size} rows x {F}, "
          f"res {cfg.base_res}..{cfg.max_res}: card vs CPU max|diff| {errs} (tol 2e-4)",
          flush=True)
    check(max(errs.values()) <= 2e-4, f"14a: encode card vs CPU {errs}")

    Q = 196608
    n_rows = L * T
    with torch.no_grad():
        keys_t = hg.corner_rows(pts[Q], cfg)[0].reshape(-1)
        ball = (torch.from_numpy(np.array([0.1, 0.2, 0.3], np.float32))
                + 0.01 * torch.nn.functional.normalize(
                    torch.from_numpy(rng.normal(size=(Q, 3)).astype(np.float32)), dim=-1)
                * torch.from_numpy(rng.uniform(0, 1, (Q, 1)).astype(np.float32)))
        keys_c = hg.corner_rows(ball.to(dev), cfg)[0].reshape(-1)
        beyond = torch.from_numpy(rng.uniform(1.6, 3.0, (Q, 3)).astype(np.float32))
        keys_b = hg.corner_rows(beyond.to(dev), cfg)[0].reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(14)
    n = keys_t.numel()
    vals = torch.randn((n, F), generator=gen, device=dev)
    runs = {}
    for tag, keys in (("typical", keys_t), ("collision-heavy", keys_c),
                      ("beyond the box", keys_b)):
        a = hs.hash_scatter(keys, vals, n_rows)
        b = hs.hash_scatter(keys, vals, n_rows)
        plain = hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows)
        lib = [torch.zeros((n_rows, F), device=dev).index_add_(0, keys, vals)
               for _ in range(2)]
        torch.cuda.synchronize()
        counts = torch.bincount(keys.long(), minlength=n_rows)
        runs[tag] = dict(
            twice=bool(torch.equal(a, b)), plain=bool(torch.equal(a.cpu(), plain)),
            lib_twice=bool(torch.equal(lib[0], lib[1])),
            lib_err=max_diff(lib[0].cpu(), plain), rows=int((counts > 0).sum()),
            longest=int(counts.max()),
            ms=cuda_ms(torch, lambda: hs.hash_scatter(keys, vals, n_rows)),
            kernel_ms=profiled_kernel_ms(torch, lambda: hs.hash_scatter(keys, vals, n_rows),
                                         "hash_scatter"),
            lib_ms=cuda_ms(torch, lambda: torch.zeros((n_rows, F), device=dev)
                           .index_add_(0, keys, vals)))
        r = runs[tag]
        kms = ("not measured" if r["kernel_ms"] is None
               else f"{r['kernel_ms']:.3f} ms")
        print(f"[hash] 14a scatter, {tag}: {n} pairs onto {r['rows']} of {n_rows} rows "
              f"(longest run {r['longest']}); card twice "
              f"{'bit-equal' if r['twice'] else 'DIFFERENT'}, card vs plain on CPU "
              f"copies {'bit-equal' if r['plain'] else 'DIFFERENT'}; index_add_ on the "
              f"card twice {'bit-equal' if r['lib_twice'] else 'different'}, vs plain "
              f"max|diff| {r['lib_err']:.3g}; the scatter {r['ms']:.3f} ms (the kernel "
              f"{kms} by the profiler), index_add_ {r['lib_ms']:.3f} ms | {card}", flush=True)
        check(r["twice"] and r["plain"], f"14a: the {tag} scatter is not bit-equal: {r}")
    torch.cuda.synchronize()
    parts = scatter_parts_ms(parts_proc)
    b_ms, b_by = bound(0.0, hash_scatter_bytes(n, F, n_rows))
    plain_ms = cuda_ms(torch, lambda: hs.hash_scatter_plain(keys_t, vals, n_rows))
    r = runs["typical"]
    kernels["hash_scatter"] = dict(
        name="hash_scatter", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/hash_scatter.cu",
        replaces="nerf_sandbox_tpu/models/hashgrid.py:121 (no pl.pallas_call: the "
                 "gradient of this gather, XLA's scatter-add; a port-only kernel)",
        max_abs_err=0.0 if r["plain"] else float("nan"), ms=r["ms"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=r["lib_ms"])
    part_text = ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}"
                          for k, v in parts.items())
    print(f"[hash] 14a scatter, typical, parts by the profiler: {part_text}; whole "
          f"{r['ms']:.3f} ms against the bound "
          f"{b_ms:.3f} ms ({b_by}: keys + values + table, "
          f"{hash_scatter_bytes(n, F, n_rows) / 1e6:.1f} MB), plain version "
          f"(index_add_) {plain_ms:.3f} ms | {card}", flush=True)

    tp = tab["card"].clone().requires_grad_(True)
    G = torch.randn((Q, cfg.out_dim), generator=gen, device=dev)

    def fwd():
        with torch.no_grad():
            hg.hash_encode(tp, pts[Q], cfg)

    def fwd_bwd():
        torch.autograd.grad(hg.hash_encode(tp, pts[Q], cfg), [tp], grad_outputs=G)

    f_ms, fb_ms = cuda_ms(torch, fwd), cuda_ms(torch, fwd_bwd)
    print(f"[hash] 14a encode at {Q} points: forward {f_ms:.3f} ms, forward + backward "
          f"{fb_ms:.3f} ms (backward {fb_ms - f_ms:.3f} ms, the scatter of "
          f"{L * Q * 8} pairs in two chunks of {cfg.chunk} points included) | {card}",
          flush=True)
    print(f"[hash] phase 14a took {time.perf_counter() - t_phase:.2f} s", flush=True)


def _hash_argv(data, out, steps):
    """14b: the CLI command of the slice on ``data``: ``--vanilla --encoder
    hashgrid --lr_grid 1e-2`` (1024 rays, 8x256, 64 + 128 samples, bf16 MLP,
    the default hash widths), the default ``--scan_steps`` (chunks of 16
    from step 101)."""
    return ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
            "--vanilla", "--encoder", "hashgrid", "--lr_grid", "1e-2",
            "--max_steps", str(steps), "--ckpt_every", str(HASH_CKPT),
            "--num_val_steps", "1", "--log_every", "50",
            "--eval_chunk", str(CLI_EVAL_CHUNK)]


def batch_scatter(torch, hs, step, card):
    """14b: the scatters of one train step on the CLI's own batch (``step``
    runs it eagerly), recorded at their launch: for each, the pairs, the
    rows they fall on, the longest run and the pairs in runs of 128 or more
    (samples clamped onto the box's faces and corners among them), the
    scatter's ms and its kernels' by the profiler, and the result bit-equal
    to the plain version on CPU copies and across two card runs."""
    seen = []
    launch = hs._launch

    def recording(keys, values, n_rows):
        seen.append((keys.clone(), values.clone(), n_rows))
        return launch(keys, values, n_rows)

    hs._launch = recording
    try:
        step()
    finally:
        hs._launch = launch
    torch.cuda.synchronize()
    for j, (keys, vals, n_rows) in enumerate(seen):
        counts = torch.bincount(keys.long(), minlength=n_rows)
        run_ms = cuda_ms(torch, lambda: hs.hash_scatter(keys, vals, n_rows))
        kernel_ms = profiled_kernel_ms(
            torch, lambda: hs.hash_scatter(keys, vals, n_rows), "hash_scatter")
        got = hs.hash_scatter(keys, vals, n_rows)
        twice = bool(torch.equal(got, hs.hash_scatter(keys, vals, n_rows)))
        same = bool(torch.equal(got.cpu(),
                                hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows)))
        kms = "not measured" if kernel_ms is None else f"{kernel_ms:.3f} ms"
        print(f"[hash] 14b the train step's scatter {j + 1} of {len(seen)}: "
              f"{keys.numel()} pairs onto {int((counts > 0).sum())} rows, longest run "
              f"{int(counts.max())}, {int(counts[counts >= 128].sum())} pairs in "
              f"{int((counts >= 128).sum())} runs of 128 or more; {run_ms:.3f} ms (the "
              f"kernels {kms}); card vs plain on CPU copies "
              f"{'bit-equal' if same else 'DIFFERENT'}, card twice "
              f"{'bit-equal' if twice else 'DIFFERENT'} | {card}", flush=True)
        check(same and twice, f"14b: the train step's scatter {j + 1} is not bit-equal "
              f"(plain {same}, twice {twice})")
    check(len(seen) > 0, "14b: the train step launched no scatter")


def phase_hash_cli(torch, dev, card, data, tmp, figures):
    """14b: ``train_nerf --vanilla --encoder hashgrid --lr_grid 1e-2`` on
    ``bench.py``'s scene: 116 steps (1-100 eager, 101-116 one chunk, as
    JAX's rule places them; checkpoints at 100 and 116, one scored
    validation on the plain path), then ``--resume latest`` to 132 (one
    chunk, 117-132), then ``--render_only`` with one 800x800 path frame.
    K2 launches 0 in every window (the gate refuses hash grids: their
    renders take the plain tile), the scatter kernel launched in the
    training windows and never in the render-only one; the loss falls.
    Then, outside the CLI, from the resumed run's state: one eager step's
    scatters on its own batch (``batch_scatter``); 16 eager steps
    twice and the captured 16-step chunk, all three bit-equal; ms/step eager
    and chunked (4 chunks), one profiled chunk's idle share; the hash
    encode's share of the path frame (the encode's time at the tiles' point
    counts x tiles over the frame's seconds). → ({kernel: launches} of the
    first training window, the resumed run's directory)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "hash")

    def counted(argv):
        torch.cuda.synchronize()
        fm.fused_nerf_apply.launches = 0
        fr.reset_launches()
        hs.hash_scatter.launches = 0
        t0 = time.perf_counter()
        trainer = train_nerf(argv)
        torch.cuda.synchronize()
        return (trainer, time.perf_counter() - t0, fr.fused_raymarch.launches,
                fm.fused_nerf_apply.launches, hs.hash_scatter.launches)

    trainer, wall, k2, k1, hsl = counted(_hash_argv(data, out, HASH_STEPS))
    st = trainer.run_stats
    want_d = predicted_dispatches(1, HASH_STEPS, 16, 101, trainer.val_steps, HASH_CKPT)
    loss1, loss_end = float(st["first_loss"]), st["losses"][-1][1]
    cli_ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / st["steps"]
    ck = os.path.join(out, "checkpoints")
    size = os.path.getsize(os.path.join(ck, f"ckpt_{HASH_STEPS:07d}.ckpt"))
    print(f"[hash] 14b --vanilla --encoder hashgrid --lr_grid 1e-2: {st['steps']} steps "
          f"in {wall:.2f} s in main, {cli_ms:.3f} ms/step in the loop (validation "
          f"{st['val_s']:.2f} s and checkpoints {st['ckpt_s']:.2f} s out); dispatches "
          f"{dispatch_text(st['dispatches'], 1)} (JAX's rule: "
          f"{dispatch_text(want_d, 1)}); loss {loss1:.6f} -> {loss_end:.6f}; scored "
          f"validation (plain tile) PSNR {st['val']['psnr_mean']:.4f} dB; launches: "
          f"K2 {k2}, K1 {k1}, hash_scatter {hsl}; checkpoint {size} bytes | {card}",
          flush=True)
    check(trainer.pos_encoder == "hashgrid" and not trainer.eval_hyper.use_kernel
          and trainer.model_cfg.enc_pos_dim == 32
          and tuple(trainer.state.model_f.pos_grid.tables.shape) == (16, 2 ** 19, 2)
          and tuple(trainer.state.model_c.pos_grid.tables.shape) == (16, 2 ** 19, 2),
          "14b: the run did not build full-width hash grids behind a closed gate")
    check(st["dispatches"] == want_d, f"14b: dispatches {st['dispatches']}")
    check(np.isfinite(loss1) and np.isfinite(loss_end) and loss_end < loss1,
          f"14b: the loss did not fall: {loss1} -> {loss_end}")
    check(k2 == 0 and k1 == 0, f"14b: K2 {k2} / K1 {k1} launches in a hash window")
    check(hsl > 0, "14b: the scatter kernel was not launched in training")
    launches = {"hash_scatter": hsl}

    trainer, wall, k2, k1, hsl = counted(_hash_argv(data, out, HASH_RESUME)
                                         + ["--resume", "latest"])
    st = trainer.run_stats
    print(f"[hash] 14b --resume latest to {HASH_RESUME}: started at {st['start_step']}, "
          f"dispatches {dispatch_text(st['dispatches'], st['start_step'])}, loss "
          f"{st['losses'][-1][1]:.6f}; {wall:.2f} s in main; K2 {k2}, hash_scatter "
          f"{hsl}", flush=True)
    check(st["start_step"] == HASH_STEPS + 1 and st["dispatches"] == [16]
          and st["end_step"] == HASH_RESUME, f"14b: resume {st}")
    check(k2 == 0 and hsl > 0, f"14b: resume window K2 {k2}, scatter {hsl}")

    # ---- a 16-step chunk against 16 eager steps ----
    k = TRAIN_SCAN
    chunk = ts.build_train_step(trainer.hyper, trainer.spec, trainer.tx,
                                trainer.pos_bands, trainer.dir_bands,
                                base_seed=int(trainer.cfg.seed), scan_steps=k,
                                device=trainer.device)
    scene = trainer.scene_arrays
    keys = ("loss", "psnr", "mse_f", "finite", "loss_mean")

    def eager_run(s):
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            s, m = chunk.step(s, scene)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        m = dict(m, loss_mean=(torch.stack(losses[:-1]).sum() + losses[-1]) / k)
        return s, m, time.perf_counter() - t0

    def flat(s, m):
        return ts.state_tensors(s) + [m[n] for n in keys]

    base = ts.clone_state(trainer.state)
    batch_scatter(torch, hs, lambda: chunk.step(ts.clone_state(base), scene), card)
    a, ma, _ = eager_run(ts.clone_state(base))
    b, mb, e_s = eager_run(ts.clone_state(base))
    eq_ee, d_ee = _bits_apart(flat(a, ma), flat(b, mb))
    g, mg = chunk(ts.clone_state(base), scene)
    mg = {n: t.clone() for n, t in mg.items()}
    eq_ge, d_ge = _bits_apart(flat(a, ma), flat(g, mg))
    print(f"[hash] 14b steps {base.host_step + 1}-{base.host_step + k}: {k} eager steps "
          f"twice {'bit-equal' if eq_ee else f'DIFFER by {d_ee:.3g}'}; the captured "
          f"chunk against them {'bit-equal' if eq_ge else f'DIFFERS by {d_ge:.3g}'} "
          f"(step, parameters with both models' tables, moments, counts, loss, psnr, "
          f"mse_f, finite, loss_mean)", flush=True)
    check(eq_ee and eq_ge, f"14b: hash steps not bit-equal (eager {d_ee:.3g}, chunk "
          f"{d_ge:.3g})")
    g, _ = chunk(g, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CHUNKS):
        g, m = chunk(g, scene)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (TRAIN_CHUNKS * k)
    eager_ms = 1e3 * e_s / k
    check(bool(m["finite"]) and chunk.captures == 1,
          f"14b: chunks finite {bool(m['finite'])}, {chunk.captures} captures")

    def one_chunk():
        nonlocal g
        g, _ = chunk(g, scene)
    traced = profile_frame(torch, one_chunk, f"hash chunk profile, {k} steps", card)
    idle = None if traced is None else traced[2]
    figures.update(hash_eager_ms=eager_ms, hash_chunk_ms=chunk_ms, hash_idle=idle,
                   hash_cli_ms=cli_ms)
    print(f"[hash] 14b ms/step: through the CLI {cli_ms:.3f} (116 steps, 100 eager), "
          f"eager {eager_ms:.3f}, chunked {chunk_ms:.3f} (chunks of {k}); device idle "
          f"share of one profiled chunk "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; vanilla in "
          f"this run (phase 8): eager {figures.get('train_ms', float('nan')):.3f}, "
          f"chunked {figures.get('chunk_ms', float('nan')):.3f} | {card}", flush=True)
    del a, b, g, base, chunk

    # ---- render_only: one 800x800 path frame on the plain tile ----
    trainer, wall, k2, k1, hsl = counted(_hash_argv(data, out, HASH_RESUME)
                                         + ["--resume", "latest", "--render_only",
                                            "--progress_frames", "1"])
    ps = trainer.path_renderer.path_stats
    f_s = ps[0]["seconds"]
    cfg = trainer.enc_cfg
    tiles = -(-IMG * IMG // CLI_EVAL_CHUNK)
    p_f = torch.rand((CLI_EVAL_CHUNK * (trainer.hyper.nc + trainer.hyper.nf), 3),
                     device=dev) * 3.0 - 1.5
    grid = trainer.state.model_f.pos_grid
    with torch.no_grad():
        fine_ms = cuda_ms(torch, lambda: grid(p_f, cfg), reps=3)
        coarse_ms = cuda_ms(torch, lambda: grid(
            p_f[:CLI_EVAL_CHUNK * trainer.hyper.nc], cfg), reps=3)
    enc_s = tiles * (fine_ms + coarse_ms) / 1e3
    figures.update(hash_frame_s=f_s)
    print(f"[hash] 14b --render_only: one {IMG}x{IMG} path frame on the plain tile in "
          f"{f_s:.3f} s ({wall:.2f} s in main); the hash encode {tiles} x (coarse "
          f"{coarse_ms:.3f} + fine {fine_ms:.3f} ms at {CLI_EVAL_CHUNK} x "
          f"{trainer.hyper.nc} / {trainer.hyper.nc + trainer.hyper.nf} points) = "
          f"{enc_s:.3f} s of it ({100 * enc_s / f_s:.1f}%); launches K2 {k2}, K1 {k1}, "
          f"hash_scatter {hsl} | {card}", flush=True)
    check(len(ps) == 1 and ps[0]["finite"], f"14b: path frame {ps}")
    check(k2 == 0 and k1 == 0 and hsl == 0,
          f"14b: render-only launches K2 {k2}, K1 {k1}, scatter {hsl}")
    print(f"[hash] phase 14b took {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches, out


def phase_hash_more(torch, dev, card, data, tmp, run, figures):
    """14c: ``--sampling occupancy --encoder hashgrid`` (the 14b command with
    occupancy, ``--scan_steps 8``, 32 steps: chunks of 8 from step 1, grid
    updates at 16 and 32), the loss finite and the grid updated, K2 0; the
    updater's ms per update (64³ cells through the hash encode and the bf16
    8x256 MLP). Then ``--render_only --export_mesh --mesh_res 128`` on
    14b's run (the hash σ sweep; at 128, not the default 256, so that the
    numpy isosurfacer stays out of the phase's time), and the σ grid at
    res 32 on the card against the CPU (fp32 1e-4, bf16 2e-2 of its
    largest). Then one step of each refiner on a seeded hash model with
    16-wide codes (fp32), card against CPU on the same draws: the pose
    gradient within 1e-2 of its largest entry, the code after the step
    within 1e-3 of its move, mse_init within 1e-4 relative; ms a step."""
    import copy

    import numpy as np

    from nerf_sandbox_tpu_torch.core.pose import apply_cam_delta
    from nerf_sandbox_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP, fold_appearance
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render import app_refine, mesh, pose_refine
    from nerf_sandbox_tpu_torch.render.renderer import EvalHyper
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run as train_nerf

    t_phase = time.perf_counter()
    argv = (_hash_argv(data, os.path.join(tmp, "hash_occ"), HASH_OCC_STEPS)
            + ["--sampling", "occupancy", "--scan_steps", str(HASH_OCC_SCAN)])
    fr.reset_launches()
    t0 = time.perf_counter()
    trainer = train_nerf(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = trainer.run_stats
    grid = trainer.occ_grid.clone()
    trainer.occ_update(grid, trainer.state.model_f, generator=trainer._occ_generator(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        trainer.occ_update(grid, trainer.state.model_f,
                           generator=trainer._occ_generator(i))
    torch.cuda.synchronize()
    upd_ms = 1e3 * (time.perf_counter() - t0) / 5
    occ_ms = 1e3 * (st["loop_s"] - st["val_s"] - st["ckpt_s"]) / st["steps"]
    figures.update(hash_occ_ms=occ_ms, hash_upd_ms=upd_ms)
    print(f"[hash] 14c --sampling occupancy --encoder hashgrid: {st['steps']} steps in "
          f"{wall:.2f} s in main ({occ_ms:.3f} ms/step in the loop, chunks of "
          f"{HASH_OCC_SCAN}, updates and captures included), dispatches "
          f"{dispatch_text(st['dispatches'], 1)}, grid updates at {st['occ_updates']}, "
          f"loss {float(st['first_loss']):.6f} -> {st['losses'][-1][1]:.6f}, occupied "
          f"cells {int((trainer.occ_grid > 0).sum())} of {trainer.occ_grid.numel()}; "
          f"K2 {fr.fused_raymarch.launches}; updater {upd_ms:.3f} ms per update "
          f"({trainer.occ_cfg.resolution}^3 cells) | {card}", flush=True)
    check(st["occ_updates"] == [16, 32] and np.isfinite(st["losses"][-1][1])
          and fr.fused_raymarch.launches == 0 and float(trainer.occ_grid.max()) > 0,
          f"14c: occupancy run {st['occ_updates']}, K2 {fr.fused_raymarch.launches}")

    # ---- the mesh export on 14b's run ----
    base = _hash_argv(data, run, HASH_RESUME) + ["--resume", "latest", "--render_only",
                                                  "--progress_frames", "1"]
    tr = train_nerf(base)
    lo, hi = tr.mesh_box()
    model = tr.state.model_f
    model_cpu = copy.deepcopy(model).to("cpu")
    errs, grids = {}, {}
    for tag, ct_ in (("fp32", None), ("bf16", torch.bfloat16)):
        kw = dict(res=MESH_CHECK_RES, lo=lo, hi=hi, compute_dtype=ct_,
                  sigma_activation=tr.cfg.sigma_activation, pos_encoder="hashgrid",
                  enc_cfg=tr.enc_cfg)
        g_dev = mesh.query_density_grid(model, tr.pos_bands, tr.dir_bands, device=dev,
                                        **kw)
        g_cpu = mesh.query_density_grid(model_cpu, tr.pos_bands, tr.dir_bands,
                                        device="cpu", **kw)
        grids[tag] = g_dev
        errs[tag] = float(np.abs(g_dev - g_cpu).max() / max(np.abs(g_cpu).max(), 1e-30))
    del model_cpu
    for q in (0.9, 0.99, 0.999, 0.9999):
        thr = float(np.quantile(grids["bf16"], q))
        n32 = len(mesh.marching_tetrahedra(grids["bf16"], thr, lo, hi)[1])
        if 0 < n32 <= MESH_FACES_32:
            break
    fr.reset_launches()
    tr = train_nerf(base + ["--export_mesh", "true", "--mesh_res", str(HASH_MESH_RES),
                            "--mesh_thr", f"{thr:.6g}"])
    ms = tr.mesh_stats[0]
    obj = os.path.join(run, "mesh", f"mesh_step_{HASH_RESUME:07d}.obj")
    print(f"[hash] 14c --render_only --export_mesh --mesh_res {HASH_MESH_RES} "
          f"--mesh_thr {thr:.6g} (σ's {100 * q:g}th percentile at {MESH_CHECK_RES}^3, "
          f"{n32} faces there): the sweep {ms['sweep_s']:.3f} s "
          f"({HASH_MESH_RES ** 3} points through the hash encode, to the host copy), "
          f"the isosurfacer {ms['surface_s']:.3f} s, the OBJ {ms['write_s']:.3f} s; "
          f"{ms['verts']} verts, {ms['faces']} faces; K2 {fr.fused_raymarch.launches}; "
          f"σ at {MESH_CHECK_RES}^3 card vs CPU max|diff| / max σ {errs} (tol fp32 1e-4, "
          f"bf16 2e-2) | {card}", flush=True)
    check(os.path.exists(obj) and ms["faces"] > 0, f"14c: OBJ {obj}: {ms}")
    check(errs["fp32"] <= 1e-4 and errs["bf16"] <= 2e-2, f"14c: σ grids {errs}")
    del tr

    # ---- one step of each refiner, card against CPU ----
    hcfg = HashGridConfig(aabb_scale=1.5)
    cfg = NeRFConfig(hcfg.out_dim, 27, 8, 256, 4, app_dim=APP_DIM)
    devs = {"cpu": torch.device("cpu"), "card": dev}
    raw = {"card": NeRFMLP(cfg, generator=torch.Generator().manual_seed(141), device=dev,
                           initial_acc_opacity=0.5, sigma_activation="relu",
                           grid_cfg=hcfg)}
    with torch.no_grad():      # features of order 1, so the tables move σ
        raw["card"].pos_grid.tables.mul_(1e4)
    raw["cpu"] = copy.deepcopy(raw["card"]).to("cpu")
    code = 0.3 * torch.randn(APP_DIM, generator=torch.Generator().manual_seed(5))
    folded = {d: fold_appearance(m, code) for d, m in raw.items()}
    hyper = EvalHyper(model=cfg._replace(app_dim=0), compute_dtype="float32",
                      pos_encoder="hashgrid", enc_cfg=hcfg)
    pos_b, dir_b = trainer.pos_bands, trainer.dir_bands
    side = CHECK_SIDE
    Ks = np.array([[FOCAL * side / IMG, 0, side / 2], [0, FOCAL * side / IMG, side / 2],
                   [0, 0, 1]], np.float32)
    true = blender_pose(1)[:3, :4]
    bad = apply_cam_delta(torch.from_numpy(true),
                          torch.tensor([0.01, -0.02, 0.015, 0.05, -0.03, 0.02])).numpy()
    gt = np.random.RandomState(141).uniform(0, 1, (side, side, 3)).astype(np.float32)
    pdraws = pose_refine.refine_draws(1, HASH_REFINE_RAYS, hyper.nc_eval, side, side, 0,
                                      "cpu")
    adraws = pose_refine.refine_draws(1, HASH_REFINE_RAYS, hyper.nc_eval, side // 2,
                                      side, 1, "cpu")
    res, grads, secs = {}, {}, {}
    for d, v in devs.items():
        pr = pose_refine.make_pose_refiner(hyper, pos_b, dir_b, device=v)
        ar = app_refine.make_appearance_refiner(hyper, pos_b, dir_b, model_cfg=cfg,
                                                model_f_raw=raw[d],
                                                code0=np.zeros(APP_DIM), device=v)
        kw = dict(steps=1, rays=HASH_REFINE_RAYS)
        for _ in range(2 if d == "card" else 1):       # the card's second run is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, pinfo = pr(folded[d], bad, Ks, side, side, gt, lr=5e-3, draws=pdraws, **kw)
            t1 = time.perf_counter()
            _, ainfo = ar(true, Ks, side, side, gt, lr=1e-2, draws=adraws, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        res[d], secs[d] = (pinfo, ainfo), (t1 - t0, t2 - t1)
        c2w_d, K_d, gt_d = pose_refine.frame_tensors(bad, Ks, gt, v)
        dr = pose_refine.as_draws(pdraws, v)
        x = torch.zeros(6, device=v, requires_grad=True)
        obj_ = pose_refine.photometric_mse(
            folded[d], hyper, pos_b, dir_b, apply_cam_delta(c2w_d, x), K_d, side, side,
            gt_d, dr["xs"][0], dr["ys"][0], dr["u"][0], use_ndc=False,
            convention="opengl", near_plane=1.0, device=v) + 0.1 * torch.sum(x ** 2)
        grads[d] = torch.autograd.grad(obj_, [x])[0].cpu()
    (pc, ac), (pg, ag) = res["cpu"], res["card"]
    g_err = float((grads["card"] - grads["cpu"]).abs().max() / grads["cpu"].abs().max())
    move = float(np.abs(ac["code"]).max())
    d_code = float(np.abs(ag["code"] - ac["code"]).max())
    rel_p = abs(pg["mse_init"] / pc["mse_init"] - 1.0)
    print(f"[hash] 14c refiners on a seeded 8x256 hash model ({hcfg.n_levels} x "
          f"2^{hcfg.log2_table_size} x {hcfg.n_features}, tables x 1e4), one step of "
          f"{HASH_REFINE_RAYS} rays x {hyper.nc_eval} samples, same draws: pose "
          f"gradient card vs CPU max|diff| / max|g| {g_err:.3g} (tol 1e-2), mse_init "
          f"rel diff {rel_p:.3g} (tol 1e-4); code card vs CPU max|diff| {d_code:.3g} of "
          f"a {move:.3g} move (tol 1e-3 of it); ms a step on the card: pose "
          f"{1e3 * secs['card'][0]:.3f}, appearance {1e3 * secs['card'][1]:.3f} (CPU "
          f"{1e3 * secs['cpu'][0]:.1f}, {1e3 * secs['cpu'][1]:.1f}) | {card}", flush=True)
    check(g_err <= 1e-2 and rel_p <= 1e-4, f"14c: pose card vs CPU {g_err}, {rel_p}")
    check(d_code <= 1e-3 * move, f"14c: code card vs CPU {d_code:.3g} (move {move:.3g})")
    print(f"[hash] phase 14c took {time.perf_counter() - t_phase:.2f} s", flush=True)


def phase_hash(torch, dev, card, kernels, figures):
    """14: ``--encoder hashgrid`` (``phase_hash_encode``, ``phase_hash_cli``,
    ``phase_hash_more``) on ``bench.py``'s scene written as a Blender
    dataset (3 train frames, frame 3 as val and test). → {kernel:
    launches}."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hash_")
    try:
        phase_hash_encode(torch, dev, card, kernels)
        images, K, c2ws = bench_frames()
        data = os.path.join(tmp, "scene")
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        launches, run = phase_hash_cli(torch, dev, card, data, tmp, figures)
        phase_hash_more(torch, dev, card, data, tmp, run, figures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[hash] phase 14 took {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 15. data parallel over rays: ranks on the card(s)
# ---------------------------------------------------------------------------

DP_WORLD, DP_STEPS, DP_TIMED_FROM = 2, 20, 5
DP_CLI_STEPS, DP_CLI_RESUME = 40, 48
# 15a: how far the ranks may sit from the whole-batch single-rank run after
# DP_STEPS steps (bf16 rounds each rank's gradients before the sum): the
# losses' largest relative difference, and the median over tensors of
# |diff| / |the run's motion|. On an H100 (700 W) the ranks read 1.07e-3
# and 0.0316 (max 0.165); a run on one rank's share of rays, which is what
# a sum that lost the other rank's rows would train, must break both.
DP_WHOLE_LOSS_REL, DP_WHOLE_MEDIAN = 1e-2, 0.1


def dp_recipe(torch, dev, micro=0, rays=TRAIN_RAYS, hidden=256):
    """Phase 8's recipe (``bench.py``'s: 1024 rays, 8x256 skip-4, 64 + 128
    samples, sigma noise 1.0, bf16 MLP, Adam 5e-4 cosine), in ``micro``
    micro-chunks, ``rays`` a batch, ``hidden`` wide → (hyper, spec, tx,
    state at seed 0, pos_bands, dir_bands)."""
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.train import step as ts
    hyper = ts.TrainHyper(model=NeRFConfig(63, 27, 8, hidden, 4), nc=64, nf=128,
                          raw_noise_std=1.0, sigma_activation="relu", white_bkgd=True,
                          infinite_last_bin=True, samp_near=2.0, samp_far=6.0,
                          micro_chunks=micro)
    spec = RayBatchSpec(rays_per_batch=rays, image_h=IMG, image_w=IMG,
                        white_bkgd=True)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 50_000, "eta_min": 5e-6})
    state = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                                generator=torch.Generator().manual_seed(0), device=dev)
    pos_b, dir_b = vanilla_encoders()
    return hyper, spec, tx, state, pos_b, dir_b


def dp_steps(torch, step, state, scene, n=DP_STEPS):
    """``n`` eager steps → (losses, state, ms/step over the steps after
    ``DP_TIMED_FROM``)."""
    losses = []
    for i in range(n):
        if i == DP_TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, scene)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n - DP_TIMED_FROM)
    return [float(v) for v in torch.stack(losses).cpu()], state, ms


def golden_models(torch, root, dev):
    """Phase 5's models: the reference's 8x256 fine weights
    (``tests/golden/mlp_state.npz``) and a coarse model seeded with 0."""
    import numpy as np

    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    cfg = NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8, hidden_dim=256,
                     skip_pos=4)
    sd = np.load(os.path.join(root, "tests", "golden", "mlp_state.npz"))
    model_f = NeRFMLP(cfg, device=dev)
    model_f.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    return cfg, model_c, model_f


def _dp_group(torch, rank, world, port, backend):
    """This process as rank ``rank`` of ``world`` through the port's
    ``initialize_multihost``: under NCCL one process of ``world`` ranks, the
    rank on its own card (as the ``--mesh_devices`` launcher lays them out);
    under gloo ``world`` processes of one rank each, all on card 0. → the
    device."""
    from nerf_sandbox_tpu_torch.parallel.dist import initialize_multihost
    coordinator = f"127.0.0.1:{port}"
    if backend == "nccl":
        initialize_multihost(coordinator, 1, 0, local_rank=rank, local_world=world,
                             backend=backend)
    else:
        initialize_multihost(coordinator, world, rank, backend=backend)
    return torch.device("cuda", torch.cuda.current_device())


def _rank15(rank, world, port, backend, tmp, root, cli):
    """15a, one spawned rank (``torch.multiprocessing``; chip_smoke.py is
    re-imported in the child): 20 eager steps of phase 8's recipe on the
    replicated bank and on the frame-sharded one (the other rank's frames
    zeroed), the all-reduce alone, and one 800x800 K2 frame from the
    ranks' shares; then, with one card, 15c's CLI on the same gloo group.
    Writes its numbers to ``tmp/rank{rank}.json`` (params, frame: .npz /
    .npy)."""
    import numpy as np
    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.data.sampler import SceneArrays
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.parallel.dist import all_reduce_sum, replicate_to_mesh
    from nerf_sandbox_tpu_torch.parallel.mesh import frame_block, make_mesh
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.train import step as ts

    dev = _dp_group(torch, rank, world, port, backend)
    plan = make_mesh(device=dev)
    out = {"rank": rank, "backend": backend, "device": str(dev)}
    hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
    replicate_to_mesh(plan, state)
    step = ts.build_train_step(hyper, spec, tx, pb, db, plan=plan, device=dev)
    out["losses"], state, out["ms"] = dp_steps(torch, step, state,
                                               bench_scene(torch, dev))
    np.savez(os.path.join(tmp, f"rank{rank}_params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in ts.named_params(state).items()})
    # the all-reduce alone: the step's flat buffer (loss, MSE, both models)
    flat = torch.zeros(2 + sum(p.numel() for p in ts.named_params(state).values()),
                       device=dev)
    for _ in range(3):
        all_reduce_sum(plan, flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        all_reduce_sum(plan, flat)
    torch.cuda.synchronize()
    out["allreduce_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    out["allreduce_bytes"] = 4 * flat.numel()
    # the frame-sharded bank: the other rank's frames zeroed, never read
    # (this rank's block: under NCCL one process holds both ranks, and
    # owned_frame_rows gives a process's frames)
    images, K, c2ws = bench_frames()
    owned = set(frame_block(len(images), plan.mesh.size, plan.mesh.index))
    frames = [Frame(image=img if i in owned else np.zeros_like(img), K=K, c2w=c2w)
              for i, (img, c2w) in enumerate(zip(images, c2ws))]
    sharded = SceneArrays.from_scene_sharded(Scene(frames=frames, white_bkgd=True),
                                             plan, device=dev)
    _, _, _, state2, _, _ = dp_recipe(torch, dev)
    replicate_to_mesh(plan, state2)
    step2 = ts.build_train_step(hyper, spec._replace(shard_frames=True), tx, pb, db,
                                plan=plan, device=dev)
    out["shard_losses"], _, out["shard_ms"] = dp_steps(torch, step2, state2, sharded)
    out["shard_frames"] = sorted(owned)
    # one K2 frame from the ranks' shares
    cfg, model_c, model_f = golden_models(torch, root, dev)
    tile = make_tile_renderer(EvalHyper(model=cfg, use_kernel=True), pb, db,
                              plan=plan, device=dev)
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]], np.float32)
    render_pose(tile, model_c, model_f, blender_pose(0), IMG, IMG, Kmat,
                eval_chunk=EVAL_CHUNK, device=dev)           # warm-up
    torch.cuda.synchronize()
    fr.reset_launches()
    t0 = time.perf_counter()
    frame = render_pose(tile, model_c, model_f, blender_pose(1), IMG, IMG, Kmat,
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    out["frame_s"] = time.perf_counter() - t0
    out["k2"] = fr.fused_raymarch.launches
    out["k2_routes"] = dict(fr.fused_raymarch.route_launches)
    out["k2_tiles"] = {f"{e}:{n}": c for (e, n), c in
                       fr.fused_raymarch.tile_launches.items()}
    np.save(os.path.join(tmp, f"rank{rank}_frame.npy"), frame["rgb"])
    if cli:
        out["cli"] = _rank15_cli(torch, cli, tmp)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    tdist.destroy_process_group()


def _rank15_cli(torch, cli, tmp):
    """15c on one card, in a rank that holds its gloo group: ``train_nerf``
    with ``--multihost`` (the group is kept, as JAX keeps an initialised
    client), then ``--resume latest``, then ``--render_only``, each with
    K2's counts zeroed before, so that each summary's ``k2_launches`` are
    its run's. → each run's summary."""
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import main
    runs = {}
    for tag, argv in cli.items():
        torch.cuda.synchronize()
        fr.reset_launches()
        t0 = time.perf_counter()
        [summary] = main(argv + ["--multihost"])
        torch.cuda.synchronize()
        runs[tag] = dict(summary, seconds=time.perf_counter() - t0)
    return runs


def _rank15b(rank, world, port, tmp, card):
    """15b, one rank on its own card over NCCL (in this process when there
    is one card): phase 8's chunk of 16 steps, captured with the sum over
    the ranks inside, against 16 eager steps from copies of one state, then
    timed. Writes ``tmp/chunk{rank}.json``."""
    import gc

    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.parallel.dist import replicate_to_mesh
    from nerf_sandbox_tpu_torch.parallel.mesh import MeshPlan, data_mesh
    from nerf_sandbox_tpu_torch.train import step as ts

    dev = _dp_group(torch, rank, world, port, "nccl")
    try:
        plan = MeshPlan(data_mesh(device=dev))       # a plan even at world 1
        hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
        replicate_to_mesh(plan, state)
        scene = bench_scene(torch, dev)
        k = TRAIN_SCAN
        chunk = ts.build_train_step(hyper, spec, tx, pb, db, scan_steps=k, plan=plan,
                                    device=dev)
        keys = ("loss", "psnr", "mse_f", "finite")
        eager = ts.clone_state(state)
        for _ in range(k):
            eager, me = chunk.step(eager, scene)
        g = ts.clone_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, mg = chunk(g, scene)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        equal, worst = _bits_apart(ts.state_tensors(eager) + [me[n] for n in keys],
                                   ts.state_tensors(g) + [mg[n] for n in keys])
        g, _ = chunk(g, scene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_CHUNKS):
            g, m = chunk(g, scene)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (TRAIN_CHUNKS * k)
        out = {"rank": rank, "world": world, "equal": equal, "worst": worst,
               "first_s": first_s, "ms": ms, "captures": chunk.captures,
               "finite": bool(m["finite"])}

        def one_chunk():
            nonlocal g
            g, _ = chunk(g, scene)
        # every rank replays (the graph's sums wait for all of them; a
        # collective in a graph has no timeout), rank 0 under the profiler
        if rank == 0:
            traced = profile_frame(torch, one_chunk,
                                   f"dp chunk profile, {k} steps, world {world}", card)
            out["idle"] = None if traced is None else traced[2]
        else:
            one_chunk()
            torch.cuda.synchronize()
        with open(os.path.join(tmp, f"chunk{rank}.json"), "w") as f:
            json.dump(out, f)
        # the graph goes before the group: NCCL's teardown waits for every
        # live graph that holds its collectives (on two cards or more)
        del chunk, one_chunk
        gc.collect()
        torch.cuda.synchronize()
    finally:
        tdist.destroy_process_group()


def _spawn_ranks(fn, args, n):
    """``fn(rank, *args)`` in ``n`` spawned processes; raises if one fails."""
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=args, nprocs=n, join=True, start_method="spawn")


def _rank15d(rank, world, port, tmp):
    """15d, one rank on its own card over NCCL: phase 8's recipe on the flat
    data axis and on ``--mesh_slices 2`` (``make_mesh_multihost``): step 1's
    summed gradients and the parameters after 8 steps. Writes
    ``tmp/{flat,slices}_{g,p}{rank}.npz`` and ``tmp/slices{rank}.json``."""
    import numpy as np
    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.parallel.dist import replicate_to_mesh
    from nerf_sandbox_tpu_torch.parallel.mesh import make_mesh, make_mesh_multihost
    from nerf_sandbox_tpu_torch.train import step as ts

    dev = _dp_group(torch, rank, world, port, "nccl")
    try:
        scene = bench_scene(torch, dev)
        out = {}
        for tag, plan in (("flat", make_mesh(device=dev)),
                          ("slices", make_mesh_multihost(2, world // 2, device=dev))):
            hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
            replicate_to_mesh(plan, state)
            step = ts.build_train_step(hyper, spec, tx, pb, db, plan=plan, device=dev)
            _, _, grads, _ = step.loss_and_grads(state, scene)
            np.savez(os.path.join(tmp, f"{tag}_g{rank}.npz"),
                     **{k: g.cpu().numpy() for k, g in grads.items()})
            losses, state, ms = dp_steps(torch, step, state, scene, n=8)
            np.savez(os.path.join(tmp, f"{tag}_p{rank}.npz"),
                     **{k: v.detach().cpu().numpy()
                        for k, v in ts.named_params(state).items()})
            out[tag] = {"losses": losses, "ms": ms}
        with open(os.path.join(tmp, f"slices{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        tdist.destroy_process_group()


def phase_dp_slices(torch, card, tmp):
    """15d, with four cards or more: ``--mesh_slices 2`` over every card
    (NCCL), the sum inside each slice, then among the slices' first ranks,
    then back inside each slice, against the flat sum: step 1's gradients
    within 1e-6 of each tensor's largest (the CPU tests' bound), and every
    rank bit-equal to the others on both axes, in the gradients and in the
    parameters after 8 steps."""
    import numpy as np

    from nerf_sandbox_tpu_torch.parallel.dist import free_port
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    _spawn_ranks(_rank15d, (n, free_port(), tmp), n)
    recs = []
    for r in range(n):
        with open(os.path.join(tmp, f"slices{r}.json")) as f:
            recs.append(json.load(f))
    worst = {}
    for kind in ("g", "p"):
        got = {tag: [dict(np.load(os.path.join(tmp, f"{tag}_{kind}{r}.npz")))
                     for r in range(n)] for tag in ("flat", "slices")}
        same = all(np.array_equal(a[k], got[tag][0][k]) for tag in got
                   for a in got[tag][1:] for k in a)
        flat, sl = got["flat"][0], got["slices"][0]
        worst[kind] = max(float(np.abs(sl[k] - v).max() / max(np.abs(v).max(), 1e-30))
                          for k, v in flat.items())
        print(f"[dp] 15d: {n} cards in 2 slices (NCCL): "
              f"{'step 1 gradients' if kind == 'g' else 'parameters after 8 steps'}: "
              f"bit-equal across ranks {same}; slices against the flat sum max "
              f"|diff| / max|flat| {worst[kind]:.3g}", flush=True)
        check(same, f"15d: the ranks differ ({kind})")
    print(f"[dp] 15d ms/step over steps {DP_TIMED_FROM + 1}-8: flat "
          f"{recs[0]['flat']['ms']:.3f}, slices {recs[0]['slices']['ms']:.3f}; "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    check(worst["g"] <= 1e-6, f"15d: slices vs flat gradients {worst['g']}")


def phase_dp(torch, dev, card, root, t4, frame1, kink1, figures, kernels):
    """15: data parallel over rays (``parallel/``), see the module's phase
    list. → {"fused_raymarch_dp": rank 0's K2 launches in 15a's frame}."""
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.parallel.dist import free_port
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import main as train_nerf
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= DP_WORLD else "gloo"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        # ---- 15a, the single-rank runs in this process: the batch whole,
        #      split into the ranks' rows as micro-chunks, and one rank's
        #      share of rays alone (what a sum that lost the other rank's
        #      rows would train) ----
        single = {}
        for tag, micro, rays in (("whole", 0, TRAIN_RAYS),
                                 ("split", DP_WORLD, TRAIN_RAYS),
                                 ("share", 0, TRAIN_RAYS // DP_WORLD)):
            hyper, spec, tx, state, pb, db = dp_recipe(torch, dev, micro, rays)
            init = {k: v.detach().clone() for k, v in ts.named_params(state).items()}
            step = ts.build_train_step(hyper, spec, tx, pb, db, device=dev)
            losses, state, ms = dp_steps(torch, step, state, bench_scene(torch, dev))
            single[tag] = (losses, {k: v.detach().cpu().numpy() for k, v in
                                    ts.named_params(state).items()}, ms)
        ms1 = single["whole"][2]
        init = {k: v.cpu().numpy() for k, v in init.items()}

        # ---- 15c inputs: bench.py's scene on disk, the CLI's flags ----
        data = os.path.join(tmp, "scene")
        images, K, c2ws = bench_frames()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        out_dir = os.path.join(tmp, "exp")
        base = ["--data_kind", "blender", "--data_root", data, "--out_dir", out_dir,
                "--vanilla", "--ckpt_every", str(DP_CLI_STEPS), "--num_val_steps", "1",
                "--log_every", "20", "--eval_chunk", str(CLI_EVAL_CHUNK)]
        cli = {"train": base + ["--max_steps", str(DP_CLI_STEPS),
                                "--progress_video_during_training",
                                "--progress_frames", "1"],
               "resume": base + ["--max_steps", str(DP_CLI_RESUME), "--resume", "latest"],
               "render": base + ["--max_steps", str(DP_CLI_RESUME), "--resume", "latest",
                                 "--render_only", "--progress_frames", "1"]}

        # ---- 15a (and 15c on one card): the ranks ----
        t0 = time.perf_counter()
        _spawn_ranks(_rank15, (DP_WORLD, free_port(), backend, tmp, root,
                               cli if backend == "gloo" else None), DP_WORLD)
        spawn_s = time.perf_counter() - t0
        recs = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        params = [dict(np.load(os.path.join(tmp, f"rank{r}_params.npz")))
                  for r in range(DP_WORLD)]
        print(f"[dp] 15a: {DP_WORLD} ranks over {backend} "
              f"({'one card each' if backend == 'nccl' else f'both on card 0: {n_cards} card(s)'}), "
              f"spawned and done in {spawn_s:.2f} s | {card}", flush=True)
        same = all(np.array_equal(params[0][k], p[k]) for p in params[1:]
                   for k in params[0])
        same_l = all(r["losses"] == recs[0]["losses"] for r in recs[1:])
        print(f"[dp] 15a: {DP_STEPS} eager steps of phase 8's recipe: parameters "
              f"bit-equal across ranks {same}, losses equal {same_l}", flush=True)
        check(same and same_l, "the ranks' replicas differ")
        # Each rank's bf16 weight gradients are rounded before the sum, as
        # a micro-chunk's are: the ranks must equal the single-rank run in
        # DP_WORLD micro-chunks (the same rows, the same halves) bit for
        # bit, and sit within DP_WHOLE_* of the whole-batch run, where a run
        # on one rank's share of rays must not.
        split_l, split_p, _ = single["split"]
        whole_l, whole_p, _ = single["whole"]
        same_split = (recs[0]["losses"] == split_l
                      and all(np.array_equal(params[0][k], v) for k, v in split_p.items()))

        def apart(losses, p):
            """→ (losses max rel, median and max over tensors of |diff| /
            |the whole run's motion|, the tensor of the max)."""
            rel = np.abs(np.asarray(losses) - whole_l) / np.abs(whole_l)
            share = {k: float(np.linalg.norm(p[k] - v)
                              / max(np.linalg.norm(v - init[k]), 1e-30))
                     for k, v in whole_p.items()}
            k = max(share, key=share.get)
            return float(rel.max()), float(np.median(list(share.values()))), share[k], k

        def text(a):
            return (f"losses max rel {a[0]:.3g}, parameters |diff| / |the run's "
                    f"motion| median {a[1]:.3g}, max {a[2]:.3g} ({a[3]})")
        ranks_apart = apart(recs[0]["losses"], params[0])
        share_apart = apart(*single["share"][:2])
        print(f"[dp] 15a against {DP_STEPS} single-rank steps on the same draws in "
              f"{DP_WORLD} micro-chunks: bit-equal {same_split}; from the "
              f"whole-batch single-rank run (bound: losses max rel <= "
              f"{DP_WHOLE_LOSS_REL:g}, median <= {DP_WHOLE_MEDIAN:g}): the ranks "
              f"{text(ranks_apart)}; the micro-chunked run "
              f"{text(apart(split_l, split_p))}; a run on "
              f"{TRAIN_RAYS // DP_WORLD} rays (one rank's share) "
              f"{text(share_apart)}", flush=True)
        check(same_split, "the ranks differ from the single-rank run in "
              f"{DP_WORLD} micro-chunks")
        for r in recs:
            print(f"[dp] 15a rank {r['rank']}: frame-sharded bank (frames "
                  f"{r['shard_frames']} decoded, the rest zero): losses equal to the "
                  f"replicated bank's {r['shard_losses'] == r['losses']}", flush=True)
            check(r["shard_losses"] == r["losses"],
                  f"rank {r['rank']}: the frame-sharded bank changed the losses")
        ms2 = recs[0]["ms"]
        figures.update(dp_ms1=ms1, dp_ms2=ms2, dp_ar_ms=recs[0]["allreduce_ms"])
        print(f"[dp] 15a ms/step, steps {DP_TIMED_FROM + 1}-{DP_STEPS}: world 1 "
              f"{ms1:.3f}, world {DP_WORLD} {ms2:.3f} (sharded bank {recs[0]['shard_ms']:.3f}); "
              f"the all-reduce alone {recs[0]['allreduce_ms']:.3f} ms for "
              f"{recs[0]['allreduce_bytes']:,} bytes ({backend}) | {card}", flush=True)

        # the frame from the shares against the single-rank K2 frame (phase 5)
        frames = [np.load(os.path.join(tmp, f"rank{r}_frame.npy"))
                  for r in range(DP_WORLD)]
        same_f = all(np.array_equal(frames[0], f) for f in frames[1:])
        drgb = np.abs(frames[0] - frame1["rgb"]).max(-1)
        d_rgb, psnr = float(drgb[~kink1].max()), compute_psnr(frames[0], frame1["rgb"])
        want = k2_launches(IMG, IMG)
        share = -(-EVAL_CHUNK // DP_WORLD)
        print(f"[dp] 15a frame {IMG}x{IMG} from {DP_WORLD} ranks' shares through K2: "
              f"{recs[0]['frame_s']:.3f} s; equal on every rank {same_f}; against the "
              f"single-rank K2 frame max|drgb| {d_rgb:.3g} off the kink (tol 2e-2), "
              f"whole-frame {float(drgb.max()):.3g}, bit-equal "
              f"{bool(np.array_equal(frames[0], frame1['rgb']))}, PSNR {psnr:.2f} dB "
              f"(min 40)", flush=True)
        print(f"[dp] 15a K2 launches per rank: {[r['k2'] for r in recs]} (routes "
              f"{recs[0]['k2_routes']}, tiles {recs[0]['k2_tiles']}); predicted "
              f"{want} = 2 passes x {want // 2} tiles, each launch on its share of "
              f"{share} rays", flush=True)
        check(same_f, "the ranks hold different frames")
        check(d_rgb <= 2e-2 and psnr >= 40.0,
              f"frame from shares vs single-rank: {d_rgb} / {psnr:.2f} dB")
        check(all(r["k2"] == want == r["k2_routes"]["freq"] for r in recs),
              f"K2 launches per rank {[r['k2'] for r in recs]}, predicted {want}")

        # K2 on one rank's share of phase 4's fine tile: the kernels-line row
        pos_bands, _ = vanilla_encoders()
        cfg, model_c, model_f = golden_models(torch, root, dev)
        pk = fm.pack_nerf_params(model_f)
        sl = slice(0, share)
        ro, rd, rn, z, enc_dir = (t4[k][sl].contiguous()
                                  for k in ("ro", "rd", "rn", "z", "enc_dir"))
        full = fr.fused_raymarch(pk, t4["ro"], t4["rd"], t4["z"], t4["rn"],
                                 t4["enc_dir"], pos_bands)
        part = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
        err = max(max_diff(a, b[sl]) for a, b in zip(part, full))
        ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                      pos_bands))
        dt = fr._deltas(z, rn, True)
        want_p = fr.fixup_outputs(*fr.fused_raymarch_plain(
            pk, ro, rd, z, dt, rn, enc_dir, pos_bands))
        enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
        kink, _ = last_bin_kink([(fm.fused_nerf_apply(pk, enc_last, enc_dir)[:, 3],
                                  fm.fused_nerf_apply_plain(pk, enc_last, enc_dir)[:, 3])])
        plain_err = hold_off_kink("K2 dp share", part, want_p, kink)
        plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
            pk, ro, rd, z, dt, rn, enc_dir, pos_bands), reps=3)
        B, N = z.shape
        b_ms, b_by = bound(2.0 * mlp_macs_per_row(cfg) * B * N,
                           B * (7 + 27) * 4 + B * N * 4 * 3 + B * 5 * 4
                           + pk.flat.numel() * 2)
        print(f"[dp] K2 on a rank's share of phase 4's fine tile ({B}x{N}): "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
              f"against the same rays of the whole tile max|diff| {err:.3g} | {card}",
              flush=True)
        check(err == 0.0, f"K2 on a share differs from the whole tile by {err}")
        kernels["fused_raymarch_dp"] = dict(
            name="fused_raymarch_dp", route="cuda",
            source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
            replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559", max_abs_err=plain_err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)

        # ---- 15b: the captured chunk with the all-reduce inside (NCCL) ----
        world_b = n_cards
        t0 = time.perf_counter()
        if world_b == 1:
            _rank15b(0, 1, free_port(), tmp, card)
        else:
            _spawn_ranks(_rank15b, (world_b, free_port(), tmp, card), world_b)
        cb = []
        for r in range(world_b):
            with open(os.path.join(tmp, f"chunk{r}.json")) as f:
                cb.append(json.load(f))
        c0 = cb[0]
        idle = "not measured" if c0.get("idle") is None else f"{100 * c0['idle']:.1f}%"
        ph8 = figures.get("chunk_ms")
        ph8_idle = figures.get("chunk_idle")
        bits = "bit-equal" if c0["equal"] else f"max|diff| {c0['worst']:.3g}"
        print(f"[dp] 15b: NCCL group of {world_b} card(s), a chunk of {TRAIN_SCAN} "
              f"steps captured with the sum over the ranks inside: against "
              f"{TRAIN_SCAN} eager steps {bits}, "
              f"on every rank {all(c['equal'] for c in cb)}; first call "
              f"{c0['first_s']:.3f} s; {c0['ms']:.3f} ms/step (idle {idle}) against "
              f"phase 8's chunk {ph8 if ph8 is None else f'{ph8:.3f}'} ms/step (idle "
              f"{'not measured' if ph8_idle is None else f'{100 * ph8_idle:.1f}%'}); "
              f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
        check(all(c["equal"] and c["captures"] == 1 and c["finite"] for c in cb),
              "the captured chunk with the all-reduce differs from eager steps")

        # ---- 15c: the CLI on two ranks ----
        per_frame, probe = k2_launches(IMG, IMG), k2_launches(8, 8)
        if backend == "nccl":
            runs = {}
            for tag, argv in cli.items():       # each run's ranks are new processes
                t0 = time.perf_counter()
                summaries = train_nerf(argv + ["--mesh_devices", str(DP_WORLD)])
                runs[tag] = [dict(r, seconds=time.perf_counter() - t0)
                             for r in summaries]
            print(f"[dp] 15c: the launcher, {DP_WORLD} ranks on {DP_WORLD} cards",
                  flush=True)
            ranks = [{tag: runs[tag][r] for tag in cli} for r in range(DP_WORLD)]
            check(not os.path.exists(os.path.join(out_dir, "proc1")),
                  "a single-process run wrote out_dir/proc1")
        else:
            try:
                train_nerf(cli["train"] + ["--mesh_devices", str(DP_WORLD)])
                refused = None
            except ValueError as e:
                refused = str(e)
            print(f"[dp] 15c: --mesh_devices {DP_WORLD} on {n_cards} card: refused: "
                  f"{refused}", flush=True)
            check(refused is not None and f"need {DP_WORLD} devices" in refused,
                  "--mesh_devices beyond the cards was not refused")
            ranks = [r["cli"] for r in recs]
            proc1 = os.path.join(out_dir, "proc1")
            p1 = sorted(os.path.relpath(os.path.join(d, f), proc1)
                        for d, _, fs in os.walk(proc1) for f in fs)
            print(f"[dp] 15c: two processes on card 0, each opening its gloo group, "
                  f"then train_nerf --multihost: out_dir/proc1 holds {len(p1)} files "
                  f"({sorted({p.split(os.sep)[0] for p in p1})})", flush=True)
            check("run_debug.json" in p1 and not any(
                p.startswith(("checkpoints", "tb", "mesh")) for p in p1),
                f"out_dir/proc1 holds what JAX's process 1 does not write: {p1}")
        ck = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
        want_ck = {f"ckpt_{s:07d}.ckpt" for s in (DP_CLI_STEPS, DP_CLI_RESUME)}
        print(f"[dp] 15c checkpoints: {ck}", flush=True)
        check(want_ck <= set(ck) and not any(c.endswith(".tmp") for c in ck)
              and sum(c.startswith("ckpt_0") for c in ck) == 2,
              f"not one checkpoint set: {ck}")
        # the start-up probe in every run; one progress frame in training,
        # one path frame under --render_only; the scored validations run the
        # plain tile (--val_exact)
        wants = {"train": probe + per_frame, "resume": probe,
                 "render": probe + per_frame}
        for tag in cli:
            digests = {r[tag]["state_sha256"] for r in ranks}
            k2, want = [r[tag]["k2_launches"] for r in ranks], wants[tag]
            print(f"[dp] 15c {tag}: steps {ranks[0][tag]['start_step']}-"
                  f"{ranks[0][tag]['end_step']}, {ranks[0][tag]['seconds']:.2f} s in "
                  f"main; states bit-equal across ranks {len(digests) == 1}; K2 "
                  f"launches per rank {k2}, predicted {want} (probe {probe}"
                  f"{'' if tag == 'resume' else f' + one {IMG}x{IMG} frame {per_frame}'})",
                  flush=True)
            check(len(digests) == 1, f"15c {tag}: the ranks' states differ")
            check(k2[0] == want, f"15c {tag}: rank 0 launched K2 {k2[0]} times, "
                  f"predicted {want}")
        check(ranks[0]["resume"]["start_step"] == DP_CLI_STEPS + 1
              and ranks[0]["resume"]["end_step"] == DP_CLI_RESUME,
              f"the resumed run: {ranks[0]['resume']}")
        losses = ranks[0]["train"]["losses"]
        check(all(np.isfinite(l) for _, l in losses), f"15c losses {losses}")
        # ---- 15d: --mesh_slices on the cards ----
        if n_cards >= 4:
            phase_dp_slices(torch, card, tmp)
        else:
            print(f"[dp] 15d (--mesh_slices on cards): needs 4 cards, this machine "
                  f"has {n_cards}: not run", flush=True)
        # 15a's bound on the whole-batch distance, held after 15b-15d so
        # that a run that fails it still reads those
        check(ranks_apart[0] <= DP_WHOLE_LOSS_REL and ranks_apart[1] <= DP_WHOLE_MEDIAN,
              f"the ranks from the whole-batch run: {text(ranks_apart)}")
        check(share_apart[0] > DP_WHOLE_LOSS_REL and share_apart[1] > DP_WHOLE_MEDIAN,
              f"the bound holds one rank's share of rays too: {text(share_apart)}")
        print(f"[dp] phase 15 took {time.perf_counter() - t_phase:.2f} s", flush=True)
        return {"fused_raymarch_dp": recs[0]["k2"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 16. tensor parallel over a model axis (--mesh_model)
# ---------------------------------------------------------------------------

TP_MODEL, TP_STEPS = 2, 10
TP_CLI_STEPS, TP_CLI_RESUME, TP_HASH_STEPS = 20, 24, 8
# 16c / 16d's scored and path frames at 50x50 (--val_res_scale /
# --path_res_scale): over gloo every cut layer's sum of a frame's samples
# crosses the host, ~2.7 GB a layer for a 400x400 frame
TP_RES_SCALE = "0.0625"
TP_CROP = 64            # 16b over gloo: the 64x64 middle of the 800x800 frame
TP_WIDE, TP_WIDE_MODEL, TP_WIDE_STEPS = 1024, 4, 5
# 16b: the frame from the model's pieces against the whole model's, both on
# the plain tile in fp32, where only the order of the cut sums differs
TP_FRAME_TOL = 1e-4


def tp_params(ts, state):
    """A host copy of the state's parameters."""
    return {k: v.detach().cpu().numpy().copy() for k, v in ts.named_params(state).items()}


def tp_param_bytes(ts, state):
    return sum(p.numel() * p.element_size() for p in ts.named_params(state).values())


def tp_frame_rays(torch, dev, crop):
    """Frame 1's rays (phase 5's pose), every pixel of the 800x800 frame or
    the ``crop`` x ``crop`` block in its middle → (o, d, |d|, view dirs)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]], np.float32)
    rays = get_camera_rays_grid(torch.from_numpy(Kmat).to(dev),
                                torch.from_numpy(blender_pose(1)).to(dev),
                                image_h=IMG, image_w=IMG, pixel_center=True)
    parts = (rays.o_march, rays.d_march_unit, rays.d_march_norm, rays.d_world_unit)
    if crop is None:
        return parts
    lo = (IMG - crop) // 2
    r = torch.arange(lo, lo + crop, device=dev)
    idx = (r[:, None] * IMG + r[None, :]).reshape(-1)
    return tuple(x[idx].contiguous() for x in parts)


def tp_frame(torch, dev, root, plan, crop):
    """16b: phase 5's models (the reference's 8x256 fine weights, a seeded
    coarse model), cut over ``plan``'s model axis when it has one, render
    ``tp_frame_rays`` on the plain tile in fp32, K1's and K2's counts zeroed
    just before → (rgb on the host, seconds, K2 launches, K1 launches)."""
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.parallel.mesh import apply_param_shardings
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_rays_chunked)
    cfg, model_c, model_f = golden_models(torch, root, dev)
    for m in (model_c, model_f):
        apply_param_shardings(plan, m)
    pb, db = vanilla_encoders()
    tile = make_tile_renderer(EvalHyper(model=cfg, use_kernel=False,
                                        compute_dtype="float32"),
                              pb, db, plan=plan, device=dev)
    rays = tp_frame_rays(torch, dev, crop)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        rgb = render_rays_chunked(tile, model_c, model_f, *rays, eval_chunk=EVAL_CHUNK,
                                  device=dev)["rgb"]
    torch.cuda.synchronize()
    return (rgb.cpu().numpy(), time.perf_counter() - t0, fr.fused_raymarch.launches,
            fm.fused_nerf_apply.launches)


def _rank16(rank, world, port, backend, tmp, root, crop, cli):
    """16a-16d, one spawned rank of a data (world / 2) x model 2 mesh: phase
    8's recipe cut over the model axis, 10 steps; the sum of a cut layer
    alone; 16b's frame from the cut models; then, on the same group, 16c's
    and 16d's CLI runs (``train_nerf.run`` with ``--multihost``: the group is
    kept). Writes ``tmp/tp{rank}.json`` and its parameters and frame."""
    import gc

    import numpy as np
    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.parallel.dist import reduce_from_model, replicate_to_mesh
    from nerf_sandbox_tpu_torch.parallel.mesh import full_state, make_mesh_2d, shard_state
    from nerf_sandbox_tpu_torch.train import step as ts

    dev = _dp_group(torch, rank, world, port, backend)
    try:
        plan = make_mesh_2d(world // TP_MODEL, TP_MODEL, device=dev)
        out = {"rank": rank, "layout": [plan.mesh.index, plan.mesh.model.index]}
        hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
        out["bytes_whole"] = tp_param_bytes(ts, state)
        state = replicate_to_mesh(plan, shard_state(plan, state))
        out["bytes_rank"] = tp_param_bytes(ts, state)
        step = ts.build_train_step(hyper, spec, tx, pb, db, plan=plan, device=dev)
        out["losses"], state, out["ms"] = dp_steps(torch, step, state,
                                                   bench_scene(torch, dev), n=TP_STEPS)
        np.savez(os.path.join(tmp, f"tp_own{rank}.npz"), **tp_params(ts, state))
        np.savez(os.path.join(tmp, f"tp_whole{rank}.npz"),
                 **tp_params(ts, full_state(plan, state)))
        # a row layer's sum over the model axis alone, at a fine pass's rows
        part = torch.randn((TRAIN_RAYS * 192, 256), device=dev)
        for _ in range(2):
            reduce_from_model(part, plan.mesh.model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            reduce_from_model(part, plan.mesh.model)
        torch.cuda.synchronize()
        out["reduce_ms"] = 1e3 * (time.perf_counter() - t0) / 5
        out["reduce_bytes"] = part.numel() * part.element_size()
        rgb, out["frame_s"], out["k2"], out["k1"] = tp_frame(torch, dev, root, plan, crop)
        np.save(os.path.join(tmp, f"tp_frame{rank}.npy"), rgb)
        out["cli"] = _rank16_cli(torch, cli)
        with open(os.path.join(tmp, f"tp{rank}.json"), "w") as f:
            json.dump(out, f)
        gc.collect()          # a CLI's chunks hold NCCL collectives in graphs
        torch.cuda.synchronize()
    finally:
        tdist.destroy_process_group()


def _rank16_cli(torch, cli):
    """16c / 16d on a rank that holds its group: each command through
    ``train_nerf.run`` with ``--multihost``, the counts of K1, K2 and the
    table-gradient scatter zeroed before → each run's summary, its counts,
    the shapes of this rank's grid tables and ms/step of its loop."""
    import gc

    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    from nerf_sandbox_tpu_torch.scripts.train_nerf import rank_summary, run
    runs = {}
    for tag, argv in cli.items():
        torch.cuda.synchronize()
        fr.reset_launches()
        fm.fused_nerf_apply.launches = 0
        hs.hash_scatter.launches = 0
        t0 = time.perf_counter()
        tr = run(argv + ["--multihost"])
        torch.cuda.synchronize()
        st = tr.run_stats or {}
        grid = tr.state.model_f.pos_grid
        runs[tag] = dict(rank_summary(tr), seconds=time.perf_counter() - t0,
                         k1=fm.fused_nerf_apply.launches, scatters=hs.hash_scatter.launches,
                         grid={k: list(p.shape) for k, p in grid.named_parameters()},
                         ms_step=(1e3 * st["loop_s"] / st["steps"]
                                  if st.get("steps") else None),
                         ckpts=sorted(os.listdir(tr.ckpt_dir)))
        del tr, grid
        gc.collect()
    return runs


def _rank16e(rank, world, port, tmp, card):
    """16e, one rank on its own card over NCCL (in this process when there
    is one card): phase 8's chunk of 16 steps on a data (world / 2) x model
    2 mesh (one card: 1 x 1, the model axis' collectives on a group of
    one), captured with the cut layers' sums and the data axis' sum inside,
    against 16 eager steps from copies of one state, then timed; with four
    cards or more also 16f, the 8x1024 trunk cut 4 ways: each rank's piece
    shapes and bytes, and 5 steps. Writes ``tmp/tpchunk{rank}.json``."""
    import gc

    import numpy as np
    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.parallel.dist import replicate_to_mesh
    from nerf_sandbox_tpu_torch.parallel.mesh import make_mesh_2d, shard_state
    from nerf_sandbox_tpu_torch.train import step as ts

    dev = _dp_group(torch, rank, world, port, "nccl")
    try:
        n_model = TP_MODEL if world > 1 else 1
        plan = make_mesh_2d(world // n_model, n_model, device=dev)
        hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
        state = replicate_to_mesh(plan, shard_state(plan, state))
        scene = bench_scene(torch, dev)
        k = TRAIN_SCAN
        chunk = ts.build_train_step(hyper, spec, tx, pb, db, scan_steps=k, plan=plan,
                                    device=dev)
        keys = ("loss", "psnr", "mse_f", "finite")
        eager = ts.clone_state(state)
        for _ in range(k):
            eager, me = chunk.step(eager, scene)
        g = ts.clone_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, mg = chunk(g, scene)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        equal, worst = _bits_apart(ts.state_tensors(eager) + [me[n] for n in keys],
                                   ts.state_tensors(g) + [mg[n] for n in keys])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_CHUNKS):
            g, m = chunk(g, scene)
        torch.cuda.synchronize()
        out = {"rank": rank, "world": world, "model": n_model, "equal": equal,
               "worst": worst, "first_s": first_s, "captures": chunk.captures,
               "ms": 1e3 * (time.perf_counter() - t0) / (TRAIN_CHUNKS * k),
               "finite": bool(m["finite"])}
        # the graph goes before the group (NCCL's teardown waits for it)
        del chunk, g, m, mg
        gc.collect()
        torch.cuda.synchronize()
        if world >= TP_WIDE_MODEL:
            wide = make_mesh_2d(world // TP_WIDE_MODEL, TP_WIDE_MODEL, device=dev)
            hyper, spec, tx, state, pb, db = dp_recipe(torch, dev, hidden=TP_WIDE)
            out["wide_bytes_whole"] = tp_param_bytes(ts, state)
            state = replicate_to_mesh(wide, shard_state(wide, state))
            out["wide_bytes_rank"] = tp_param_bytes(ts, state)
            out["wide_shapes"] = {k: list(p.shape) for k, p in
                                  state.model_f.named_parameters() if k.startswith("mlp.")}
            step = ts.build_train_step(hyper, spec, tx, pb, db, plan=wide, device=dev)
            out["wide_losses"], _, out["wide_ms"] = dp_steps(
                torch, step, state, scene, n=TP_WIDE_STEPS + DP_TIMED_FROM)
        with open(os.path.join(tmp, f"tpchunk{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        tdist.destroy_process_group()


def tp_scatter_row(torch, dev, card, kernels):
    """The table-gradient scatter on a rank's piece of the hash tables
    (16 levels x 2^19 rows x 1 feature, the default F = 2 cut 2 ways), at a
    fine pass's 25.2 M pairs (phase 14a's typical points): bit-equal to the
    plain version on CPU copies and across two card runs, timed beside its
    bound and ``index_add_`` → the kernels line's ``hash_scatter_tp`` row
    (launches: 16d's)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    cfg = hg.HashGridConfig(aabb_scale=1.5)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features // TP_MODEL
    rng = np.random.RandomState(16)
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (196608, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        keys = hg.corner_rows(pts, cfg)[0].reshape(-1)
    n, n_rows = keys.numel(), L * T
    vals = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(16),
                       device=dev)
    got = hs.hash_scatter(keys, vals, n_rows)
    twice = bool(torch.equal(got, hs.hash_scatter(keys, vals, n_rows)))
    same = bool(torch.equal(got.cpu(), hs.hash_scatter_plain(keys.cpu(), vals.cpu(),
                                                             n_rows))) and twice
    ms = cuda_ms(torch, lambda: hs.hash_scatter(keys, vals, n_rows))
    plain_ms = cuda_ms(torch, lambda: hs.hash_scatter_plain(keys, vals, n_rows))
    lib_ms = cuda_ms(torch, lambda: torch.zeros((n_rows, F), device=dev)
                     .index_add_(0, keys, vals))
    b_ms, b_by = bound(0.0, hash_scatter_bytes(n, F, n_rows))
    print(f"[tp] 16d the table-gradient scatter on a rank's piece ({L} x 2^"
          f"{cfg.log2_table_size} x {F}), {n} pairs: card vs plain on CPU copies "
          f"and across two card runs {'bit-equal' if same else 'DIFFERENT'}; "
          f"{ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, index_add_ {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) | {card}",
          flush=True)
    check(same, "16d: the scatter on a rank's piece is not bit-equal to plain")
    kernels["hash_scatter_tp"] = dict(
        name="hash_scatter_tp", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/hash_scatter.cu",
        replaces="nerf_sandbox_tpu/models/hashgrid.py:121 (no pl.pallas_call: the "
                 "gradient of this gather on a rank's feature piece, XLA's "
                 "scatter-add; a port-only kernel)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)


def phase_tp(torch, dev, card, root, kernels):
    """16: tensor parallel over a model axis (``--mesh_model``), see the
    module's phase list. → {"hash_scatter_tp": rank 0's scatters in 16d}."""
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.parallel.dist import free_port
    from nerf_sandbox_tpu_torch.scripts.train_nerf import rank_summary, run
    from nerf_sandbox_tpu_torch.train import step as ts

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    nccl = n_cards >= 2 * TP_MODEL
    world, backend = (2 * TP_MODEL, "nccl") if nccl else (TP_MODEL, "gloo")
    crop = None if nccl else TP_CROP
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        # ---- one rank: 16a's steps and 16b's frame from the whole models ----
        hyper, spec, tx, state, pb, db = dp_recipe(torch, dev)
        init = tp_params(ts, state)
        step = ts.build_train_step(hyper, spec, tx, pb, db, device=dev)
        losses1, state, ms1 = dp_steps(torch, step, state, bench_scene(torch, dev),
                                       n=TP_STEPS)
        whole1 = tp_params(ts, state)
        frame1, frame1_s, _, _ = tp_frame(torch, dev, root, None, crop)

        # ---- 16c / 16d inputs: bench.py's scene on disk, the commands ----
        data = os.path.join(tmp, "scene")
        images, K, c2ws = bench_frames()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        small = ["--val_res_scale", TP_RES_SCALE, "--path_res_scale", TP_RES_SCALE]
        occ_dir = os.path.join(tmp, "occ")
        occ = (_occ_argv(data, occ_dir) + small
               + ["--max_steps", str(TP_CLI_STEPS), "--ckpt_every", str(TP_CLI_STEPS)]
               + ([] if nccl else ["--scan_steps", "1"]))   # gloo: no capture
        resume = ["--max_steps", str(TP_CLI_RESUME), "--resume", "latest"]
        tp = ["--mesh_model", str(TP_MODEL)]
        cli = {"occ": occ + tp, "occ_resume": occ + tp + resume,
               "occ_render": occ + tp + resume + ["--render_only", "--progress_frames", "1"],
               "hash": (_hash_argv(data, os.path.join(tmp, "hash"), TP_HASH_STEPS) + small
                        + tp + ["--ckpt_every", str(TP_HASH_STEPS)])}

        # ---- 16a-16d: the ranks ----
        t0 = time.perf_counter()
        _spawn_ranks(_rank16, (world, free_port(), backend, tmp, root, crop, cli), world)
        spawn_s = time.perf_counter() - t0
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, f"tp{r}.json")) as f:
                recs.append(json.load(f))
        own = [dict(np.load(os.path.join(tmp, f"tp_own{r}.npz"))) for r in range(world)]
        whole = [dict(np.load(os.path.join(tmp, f"tp_whole{r}.npz"))) for r in range(world)]
        print(f"[tp] 16: {world} ranks over {backend} (data {world // TP_MODEL} x model "
              f"{TP_MODEL}; {'one card each' if nccl else f'all on card 0: {n_cards} card(s)'}"
              f"), spawned and done in {spawn_s:.2f} s | {card}", flush=True)
        check([r["layout"] for r in recs] == [[r // TP_MODEL, r % TP_MODEL]
                                              for r in range(world)],
              f"16: the mesh layout {[r['layout'] for r in recs]}")

        # 16a: whole state equal on every rank; uncut tensors equal on the
        # model ranks; against the one-rank run on the same draws
        same_whole = all(np.array_equal(w[k], whole[0][k]) for w in whole[1:] for k in w)
        cut = {k for k in own[0] if own[0][k].shape != whole[0][k].shape}
        same_rep = all(np.array_equal(own[r][k], own[r - r % TP_MODEL][k])
                       for r in range(world) for k in own[r] if k not in cut)
        same_data = all(np.array_equal(own[r][k], own[r % TP_MODEL][k])
                        for r in range(world) for k in own[r])
        rel = float(np.max(np.abs(np.asarray(recs[0]["losses"]) - losses1)
                           / np.abs(losses1)))
        share = {k: float(np.linalg.norm(whole[0][k] - v)
                          / max(np.linalg.norm(v - init[k]), 1e-30))
                 for k, v in whole1.items()}
        med, worst = float(np.median(list(share.values()))), max(share, key=share.get)
        bits = all(np.array_equal(whole[0][k], v) for k, v in whole1.items())
        print(f"[tp] 16a: {TP_STEPS} eager steps of phase 8's recipe, {len(cut)} of "
              f"{len(own[0])} tensors cut: the whole state equal on every rank "
              f"{same_whole}, uncut tensors equal on the model ranks {same_rep}, the "
              f"data ranks equal {same_data}; against {TP_STEPS} one-rank steps on the "
              f"same draws: bit-equal {bits}, losses max rel {rel:.3g}, parameters "
              f"|diff| / |the run's motion| median {med:.3g}, max {share[worst]:.3g} "
              f"({worst}) (bound: {DP_WHOLE_LOSS_REL:g}, {DP_WHOLE_MEDIAN:g}) | {card}",
              flush=True)
        check(same_whole and same_rep and same_data and cut,
              "16a: the ranks' tensors differ where they must agree")
        check(rel <= DP_WHOLE_LOSS_REL and med <= DP_WHOLE_MEDIAN,
              f"16a: the cut model from the one-rank run: {rel}, {med}")
        r0 = recs[0]
        print(f"[tp] 16a ms/step, steps {DP_TIMED_FROM + 1}-{TP_STEPS}: one rank "
              f"{ms1:.3f}, the model axis {r0['ms']:.3f}; a row layer's sum over the "
              f"model axis alone {r0['reduce_ms']:.3f} ms for {r0['reduce_bytes']:,} "
              f"bytes ({backend}); parameter bytes a rank {r0['bytes_rank']:,} of the "
              f"whole model's {r0['bytes_whole']:,} "
              f"({r0['bytes_rank'] / r0['bytes_whole']:.3f}) | {card}", flush=True)

        # 16b: the frame (or its middle) from the cut models, plain tile, fp32
        frames = [np.load(os.path.join(tmp, f"tp_frame{r}.npy")) for r in range(world)]
        d_rgb = float(np.abs(frames[0] - frame1).max())
        what = f"{IMG}x{IMG} frame" if crop is None else f"{crop}x{crop} middle of the frame"
        print(f"[tp] 16b the {what} from the cut models on the plain tile (fp32): "
              f"{r0['frame_s']:.3f} s (one rank {frame1_s:.3f} s); equal on every rank "
              f"{all(np.array_equal(frames[0], f) for f in frames[1:])}; against the "
              f"one-rank frame max|drgb| {d_rgb:.3g} (tol {TP_FRAME_TOL:g}); K2 "
              f"launches {[r['k2'] for r in recs]}, K1 {[r['k1'] for r in recs]} "
              f"| {card}", flush=True)
        check(all(r["k2"] == 0 and r["k1"] == 0 for r in recs),
              "16b: K1 or K2 launched under a model axis")
        check(d_rgb <= TP_FRAME_TOL and all(np.array_equal(frames[0], f)
                                            for f in frames[1:]),
              f"16b: the cut models' frame from the one-rank frame {d_rgb}")

        # 16c: the 360 occupancy command with --mesh_model
        runs = [r["cli"] for r in recs]
        for tag in ("occ", "occ_resume", "occ_render", "hash"):
            rr = runs[0][tag]
            ms = "n/a" if rr["ms_step"] is None else f"{rr['ms_step']:.3f} ms/step"
            print(f"[tp] 16{'d' if tag == 'hash' else 'c'} {tag}: steps {rr['start_step']}"
                  f"-{rr['end_step']}, {rr['seconds']:.2f} s in run ({ms}); states "
                  f"equal on every rank {len({x[tag]['state_sha256'] for x in runs}) == 1}; "
                  f"K2 {[x[tag]['k2_launches'] for x in runs]}, K1 "
                  f"{[x[tag]['k1'] for x in runs]}, table-gradient scatters "
                  f"{[x[tag]['scatters'] for x in runs]}; rank 0's grid pieces "
                  f"{rr['grid']} | {card}", flush=True)
            check(len({x[tag]["state_sha256"] for x in runs}) == 1,
                  f"16 {tag}: the ranks' states differ")
            check(all(x[tag]["k2_launches"] == 0 and x[tag]["k1"] == 0 for x in runs),
                  f"16 {tag}: K1 or K2 launched under a model axis")
        occ_r = runs[0]["occ"]
        check(occ_r["grid"]["plane0_xy"][-1] == 8 // TP_MODEL
              and occ_r["grid"]["line_x"][-1] == 16 // TP_MODEL,
              f"16c: the k-planes tables are not cut {TP_MODEL} ways: {occ_r['grid']}")
        check(runs[0]["occ_resume"]["start_step"] == TP_CLI_STEPS + 1
              and runs[0]["occ_resume"]["end_step"] == TP_CLI_RESUME,
              f"16c: the resumed run {runs[0]['occ_resume']}")
        ck = runs[0]["occ_resume"]["ckpts"]
        want_ck = {f"ckpt_{s:07d}.ckpt" for s in (TP_CLI_STEPS, TP_CLI_RESUME)}
        check(want_ck <= set(ck) and sum(c.startswith("ckpt_0") for c in ck) == 2
              and not any(c.endswith(".tmp") for c in ck), f"16c: checkpoints {ck}")
        # the ranks' checkpoint into one rank: the whole state they gathered
        copy_dir = os.path.join(tmp, "occ_one")
        shutil.copytree(occ_dir, copy_dir)
        one = rank_summary(run(_occ_argv(data, copy_dir) + small + resume))
        print(f"[tp] 16c checkpoints {ck}; loaded into one rank: step {one['step']}, "
              f"the state the ranks gathered {one['state_sha256'] == runs[0]['occ_resume']['state_sha256']}",
              flush=True)
        check(one["state_sha256"] == runs[0]["occ_resume"]["state_sha256"],
              "16c: the one-rank load differs from the ranks' whole state")
        # 16d: the hash tables cut on their feature axis
        hr = runs[0]["hash"]
        check(hr["grid"]["tables"] == [16, 1 << 19, 2 // TP_MODEL],
              f"16d: hash table pieces {hr['grid']}")
        check(all(x["hash"]["scatters"] > 0 for x in runs),
              "16d: a rank launched no table-gradient scatter")
        tp_scatter_row(torch, dev, card, kernels)

        # ---- 16e (and 16f with four cards): the chunk, the wide trunk ----
        t0 = time.perf_counter()
        world_e = 2 * TP_MODEL if nccl else 1
        if world_e == 1:
            _rank16e(0, 1, free_port(), tmp, card)
        else:
            _spawn_ranks(_rank16e, (world_e, free_port(), tmp, card), world_e)
        ce = []
        for r in range(world_e):
            with open(os.path.join(tmp, f"tpchunk{r}.json")) as f:
                ce.append(json.load(f))
        c0 = ce[0]
        bits = "bit-equal" if c0["equal"] else f"max|diff| {c0['worst']:.3g}"
        print(f"[tp] 16e: NCCL, data {world_e // c0['model']} x model {c0['model']}, a "
              f"chunk of {TRAIN_SCAN} steps captured with the model axis' sums and the "
              f"data axis' sum inside: against {TRAIN_SCAN} eager steps {bits}"
              f", on every rank {all(c['equal'] for c in ce)}; first call "
              f"{c0['first_s']:.3f} s; {c0['ms']:.3f} ms/step; {time.perf_counter() - t0:.2f} s "
              f"| {card}", flush=True)
        check(all(c["equal"] and c["captures"] == 1 and c["finite"] for c in ce),
              "16e: the captured chunk with the model axis' sums differs from eager steps")
        if "wide_losses" in c0:
            hyper, spec, tx, state, pb, db = dp_recipe(torch, dev, hidden=TP_WIDE)
            step = ts.build_train_step(hyper, spec, tx, pb, db, device=dev)
            wl, _, wms = dp_steps(torch, step, state, bench_scene(torch, dev),
                                  n=TP_WIDE_STEPS + DP_TIMED_FROM)
            wrel = float(np.max(np.abs(np.asarray(c0["wide_losses"]) - wl) / np.abs(wl)))
            sh = c0["wide_shapes"]
            print(f"[tp] 16f the 8x{TP_WIDE} trunk cut {TP_WIDE_MODEL} ways: rank 0's "
                  f"pieces mlp.0 {sh['mlp.0.weight']}, mlp.1 {sh['mlp.1.weight']}, "
                  f"mlp.4 {sh['mlp.4.weight']}; parameter bytes a rank "
                  f"{c0['wide_bytes_rank']:,} of {c0['wide_bytes_whole']:,} "
                  f"({c0['wide_bytes_rank'] / c0['wide_bytes_whole']:.3f}); "
                  f"{TP_WIDE_STEPS + DP_TIMED_FROM} steps against one rank: losses max "
                  f"rel {wrel:.3g} (bound {DP_WHOLE_LOSS_REL:g}); ms/step {c0['wide_ms']:.3f}"
                  f", one rank {wms:.3f} | {card}", flush=True)
            check(sh["mlp.0.weight"] == [TP_WIDE // TP_WIDE_MODEL, 63]
                  and sh["mlp.1.weight"] == [TP_WIDE, TP_WIDE // TP_WIDE_MODEL],
                  f"16f: the wide trunk's pieces {sh}")
            check(wrel <= DP_WHOLE_LOSS_REL, f"16f: the wide trunk's losses {wrel}")
        else:
            print(f"[tp] 16f (the 8x{TP_WIDE} trunk cut {TP_WIDE_MODEL} ways): needs "
                  f"{TP_WIDE_MODEL} cards, this machine has {n_cards}: not run", flush=True)
        print(f"[tp] phase 16 took {time.perf_counter() - t_phase:.2f} s", flush=True)
        return {"hash_scatter_tp": runs[0]["hash"]["scatters"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 17: checkpoints and signals
# ---------------------------------------------------------------------------

CK_STEPS, CK_RESUME, CK_EVERY, CK_KEEP = 60, 80, 20, 2
SIG_MARK = 2            # 17b: dispatches on rank 1 before its SIGUSR1
SIG_STEPS = 2000        # 17b: a bound the SIGINT ends long before
HB_LIMIT_S = 15.0       # 17c: the heartbeat limit, cut from 100 s as the tests cut it
HB_GRACE_S = 30.0       # 17c: the survivor's exit within the limit plus this
HB_MARK = 8             # 17c: rank 0's checkpoint at this step starts the kill


def ckpt_saved_steps(start, max_steps, every):
    """The steps a run from ``start`` to ``max_steps`` saves at: every
    multiple of ``every``, and ``max_steps`` (the end-of-run save)."""
    steps = [s for s in range(start, max_steps + 1) if s % every == 0]
    return steps if max_steps in steps else steps + [max_steps]


def orbax_kept(saved, keep):
    """The steps orbax's manager keeps of ``saved`` under ``max_to_keep``
    ``keep``: the newest ``keep``."""
    return sorted(saved)[-keep:] if keep else sorted(saved)


def tagged_names(pause, interrupt):
    """The signal saves' file names: a pause at step ``pause``, an
    interrupt at ``interrupt``."""
    return sorted([f"pause_step_{pause}.ckpt", f"interrupt_step_{interrupt}.ckpt"])


def orbax_name(npz_key):
    """An npz key (``params_c||['trunk']||[0]||['w']``, ``opt||[1]||.count``,
    ``extra||occ_grid``) → the orbax array of the same leaf
    (``state.params_c.trunk.0.w``, ``state.opt_state.1.count``,
    ``extra.occ_grid``)."""
    head, *parts = npz_key.split("||")
    root = {"params_c": "state.params_c", "params_f": "state.params_f",
            "opt": "state.opt_state", "extra": "extra"}[head]
    names = [re.sub(r"^\['(.*)'\]$|^\[(\d+)\]$|^\.(\w+)$",
                    lambda m: next(g for g in m.groups() if g is not None), p)
             for p in parts]
    return ".".join([root] + names)


HB_LINE = "[dist] rank 0:"     # 17c: the heartbeat's line on the survivor's stderr


def survivor_verdict(exitcode, seconds, limit, grace=HB_GRACE_S, stderr=None):
    """17c: did the survivor end as it must (non-zero, within ``limit`` +
    ``grace`` seconds of its peer's death; when ``stderr`` is given, with
    the heartbeat's ``HB_LINE`` in it)? → (ok, what happened)."""
    if exitcode is None:
        return False, f"still running {seconds:.1f} s after its peer died"
    if exitcode == 0:
        return False, f"exited 0 after {seconds:.1f} s: its peer's death went unnoticed"
    if seconds > limit + grace:
        return False, (f"exited {exitcode} after {seconds:.1f} s, past the limit "
                       f"{limit:g} s + {grace:g} s")
    what = f"exited {exitcode} after {seconds:.1f} s (limit {limit:g} s + {grace:g} s)"
    if stderr is not None:
        line = next((ln for ln in stderr.splitlines() if ln.startswith(HB_LINE)), None)
        if line is None:
            return False, f"{what}, but not by its heartbeat: no {HB_LINE!r} line"
        what += f", by its heartbeat: {line!r}"
    return True, what


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _npz_arrays(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def npz_as_orbax(path):
    """An npz checkpoint's arrays under the names of the orbax arrays that
    hold the same leaves, its step (in the npz's ``__meta__``) as orbax's
    int32 ``state.step``."""
    import numpy as np
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    out = {orbax_name(k): v for k, v in _npz_arrays(path).items()}
    out["state.step"] = np.asarray(meta["step"], np.int32)
    return out


def counted_cli(torch, argv):
    """``train_nerf.run(argv)`` with K1's and K2's counts set to 0 just
    before and read just after → (trainer, seconds in ``run``, K2
    launches, K2 launches by route, K1 launches)."""
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run
    torch.cuda.synchronize()
    fm.fused_nerf_apply.launches = 0
    fr.reset_launches()
    t0 = time.perf_counter()
    trainer = run(argv)
    torch.cuda.synchronize()
    return (trainer, time.perf_counter() - t0, fr.fused_raymarch.launches,
            dict(fr.fused_raymarch.route_launches), fm.fused_nerf_apply.launches)


def phase_ckpt(torch, card):
    """17a: ``--vanilla`` on ``bench.py``'s scene under ``--ckpt_backend
    orbax --ckpt_every 20 --ckpt_max_to_keep 2`` for 60 steps, then
    ``--resume latest`` to 80, and the same under npz: every orbax step
    (read as it is written, before retention drops it) bit-equal to the npz
    file of its step, only the newest two steps kept; each backend's
    seconds a save holds the loop and bytes on disk; one ``--render_only``
    frame from the orbax step through K2, its launches counted in its run's
    window."""
    import shutil
    import tempfile

    import numpy as np

    from nerf_sandbox_tpu_torch.train import orbax_ckpt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    seen = {}
    retain = orbax_ckpt.OrbaxCheckpointer._retain

    def retain_reading(self):
        # on the save's worker thread: read each step before any is dropped
        for s in self.all_steps():
            if s not in seen:
                seen[s] = orbax_ckpt.read_arrays(self.step_dir(s))
        retain(self)

    orbax_ckpt.OrbaxCheckpointer._retain = retain_reading
    try:
        data = os.path.join(tmp, "scene")
        images, K, c2ws = bench_frames()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})

        def argv(out, *extra):
            return ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
                    "--vanilla", "--ckpt_every", str(CK_EVERY), "--num_val_steps", "1",
                    "--val_res_scale", "0.125", "--log_every", "20", "--eval_chunk",
                    str(CLI_EVAL_CHUNK), *extra]

        ob_flags = ["--ckpt_backend", "orbax", "--ckpt_max_to_keep", str(CK_KEEP)]
        dirs = {"orbax": os.path.join(tmp, "ob"), "npz": os.path.join(tmp, "npz")}
        saves = {}
        for leg, (start, end) in (("first", (1, CK_STEPS)),
                                  ("resume", (CK_STEPS + 1, CK_RESUME))):
            extra = ["--max_steps", str(end)] + (["--resume", "latest"]
                                                 if leg == "resume" else [])
            for be in ("orbax", "npz"):
                tr, wall, _, _, _ = counted_cli(torch, argv(dirs[be], *extra,
                                                    *(ob_flags if be == "orbax" else [])))
                st = tr.run_stats
                n = len(ckpt_saved_steps(start, end, CK_EVERY))
                check((st["start_step"], st["end_step"]) == (start, end),
                      f"17a {be} {leg}: ran {st['start_step']}..{st['end_step']}")
                saves.setdefault(be, []).append((leg, st["ckpt_s"] / n, n, wall))
                if be == "orbax":
                    kept = tr.orbax.all_steps()
                    want = orbax_kept(ckpt_saved_steps(1, end, CK_EVERY), CK_KEEP)
                    print(f"[ckpt] 17a orbax {leg}: steps kept {kept} (orbax's rule "
                          f"{want}); {n} saves held the loop {st['ckpt_s']:.3f} s in "
                          f"all; {wall:.2f} s in main", flush=True)
                    check(kept == want, f"17a: orbax kept {kept}, max_to_keep "
                          f"{CK_KEEP} keeps {want}")
        ck_np = os.path.join(dirs["npz"], "checkpoints")
        ck_ob = os.path.join(dirs["orbax"], "checkpoints")
        every = ckpt_saved_steps(1, CK_RESUME, CK_EVERY)
        check(sorted(seen) == every, f"17a: orbax wrote steps {sorted(seen)}, "
              f"the runs save at {every}")
        for s in every:
            want = npz_as_orbax(os.path.join(ck_np, f"ckpt_{s:07d}.ckpt"))
            got = seen[s]
            same = (got.keys() == want.keys()
                    and all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                            for k in want))
            check(same, f"17a: orbax step {s} is not the npz state of step {s} "
                  f"({len(got)} vs {len(want)} arrays)")
        npz_bytes = os.path.getsize(os.path.join(ck_np, f"ckpt_{CK_RESUME:07d}.ckpt"))
        ob_bytes = _dir_bytes(os.path.join(ck_ob, str(CK_RESUME)))
        n_arrays = len(seen[CK_RESUME])
        n_floats = sum(a.size for a in seen[CK_RESUME].values())
        for be in ("orbax", "npz"):
            print(f"[ckpt] 17a {be}: seconds a save holds the loop "
                  + ", ".join(f"{leg} {s:.4f} ({n} saves, {w:.2f} s in main)"
                              for leg, s, n, w in saves[be]), flush=True)
        print(f"[ckpt] 17a: every saved step {every} bit-equal between the backends "
              f"({n_arrays} arrays, {n_floats} values); bytes on disk a step: npz "
              f"{npz_bytes}, orbax {ob_bytes} (zstd raw blocks) | {card}", flush=True)

        # one --render_only frame from the orbax step, through K2
        tr, wall, k2, routes, _ = counted_cli(torch, argv(dirs["orbax"], "--max_steps",
                                                  str(CK_RESUME), "--resume", "latest",
                                                  "--render_only", "--progress_frames",
                                                  "1", *ob_flags))
        ps = tr.path_renderer.path_stats
        probe, frame = k2_launches(8, 8), k2_launches(IMG, IMG, 2)
        print(f"[ckpt] 17a --render_only from orbax step {tr.state.host_step}: "
              f"{len(ps)} frame {IMG}x{IMG} in {ps[0]['seconds']:.3f} s, finite "
              f"{ps[0]['finite']}; K2 launches {k2} = probe {probe} + the frame's "
              f"k2_launches({IMG}, {IMG}, 2) = {frame} ({routes}); {wall:.2f} s in "
              f"main | {card}", flush=True)
        check(tr.state.host_step == CK_RESUME, f"17a: --render_only loaded step "
              f"{tr.state.host_step}")
        check(len(ps) == 1 and ps[0]["finite"], f"17a: the frame {ps}")
        check(k2 == probe + frame and routes["freq"] == k2,
              f"17a: K2 launched {k2} times ({routes}), want {probe} + {frame}")
        print(f"[ckpt] phase 17a took {time.perf_counter() - t_phase:.2f} s", flush=True)
    finally:
        orbax_ckpt.OrbaxCheckpointer._retain = retain
        shutil.rmtree(tmp, ignore_errors=True)


def sig_argv(data, out, *extra):
    """17b / 17c: a small frequency recipe on ``bench.py``'s scene."""
    return ["--data_kind", "blender", "--data_root", data, "--out_dir", out,
            "--hidden_dim", "64", "--n_layers", "4", "--skip_pos", "2",
            "--rays_per_batch", "128", "--nc", "16", "--nf", "16",
            "--num_val_steps", "1", "--val_res_scale", "0.0625", "--log_every", "50",
            "--eval_chunk", str(CLI_EVAL_CHUNK), *extra]


def file_cuts_to_own_pieces(tr, path):
    """17b: the checkpoint ``path`` loaded into the whole state and cut into
    this rank's pieces (``load_shards_``): bit for bit the rank's own
    tensors? A gather that put a piece in the wrong place, or took it from
    the wrong rank, gives some rank another piece. Every rank of the data
    index calls it (the whole state's template is gathered)."""
    import torch

    from nerf_sandbox_tpu_torch.parallel.mesh import full_state, load_shards_
    from nerf_sandbox_tpu_torch.train import checkpoints as ckpt
    from nerf_sandbox_tpu_torch.train.step import clone_state, state_tensors
    whole = full_state(tr.plan, tr.state)
    ckpt.load_checkpoint(path, whole, tr.tx)
    mine = clone_state(tr.state)
    load_shards_(tr.plan, mine, whole)
    return all(torch.equal(a, b) for a, b in zip(state_tensors(mine),
                                                 state_tensors(tr.state)))


def _rank17b(rank, world, port, backend, tmp, data, scan, device=None):
    """17b, one spawned rank of data (world / 2) x model 2: ``train_nerf
    --mesh_model 2 --multihost`` on its group until the parent's SIGINT;
    rank 1 marks its ``SIG_MARK``-th dispatch; every tagged save is also
    written by a one-rank trainer's save of the gathered state
    (``tmp/onerank``), and after the run each rank cuts the interrupt save
    back into its pieces (``file_cuts_to_own_pieces``); the agreement alone
    is timed after the run. On the card unless ``device`` is "cpu" (the CPU
    rehearsal)."""
    from dataclasses import asdict

    import torch

    import torch.distributed as tdist
    from nerf_sandbox_tpu_torch.parallel import dist
    from nerf_sandbox_tpu_torch.parallel.mesh import full_state
    from nerf_sandbox_tpu_torch.scripts.train_nerf import rank_summary, run
    from nerf_sandbox_tpu_torch.train import checkpoints as ckpt
    from nerf_sandbox_tpu_torch.train.trainer import Trainer

    if device == "cpu":
        dist.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    else:
        _dp_group(torch, rank, world, port, backend)
    try:
        agree, calls = dist.agree_flags, [0]

        def agree_marking(flags, **kw):
            calls[0] += 1
            if calls[0] == SIG_MARK:
                with open(os.path.join(tmp, f"mark{rank}"), "w") as f:
                    f.write("dispatching")
            return agree(flags, **kw)

        save = Trainer.save_checkpoint

        def save_and_one_rank(self, step, tag=None):
            path = save(self, step, tag)
            if tag is not None:
                state = self.state
                if self.tensor_parallel and self.plan.mesh.index == 0:
                    state = full_state(self.plan, self.state)
                if self.is_main:
                    ckpt.save_checkpoint(os.path.join(tmp, "onerank"), step, state,
                                         self.tx, asdict(self.cfg), tag=tag)
            return path

        dist.agree_flags, Trainer.save_checkpoint = agree_marking, save_and_one_rank
        try:
            tr = run(sig_argv(data, os.path.join(tmp, "tp"), "--mesh_model", "2",
                              "--max_steps", str(SIG_STEPS), "--ckpt_every", "100000",
                              "--scan_steps", str(scan), "--multihost"), device=device)
        finally:
            dist.agree_flags, Trainer.save_checkpoint = agree, save
        st = tr.run_stats
        tagged = os.path.join(tmp, "tp", "checkpoints",
                              f"interrupt_step_{st['end_step']}.ckpt")
        pieces_equal = file_cuts_to_own_pieces(tr, tagged)
        t0 = time.perf_counter()
        for _ in range(200):
            dist.agree_flags([False, False, False])
        agree_us = 1e6 * (time.perf_counter() - t0) / 200
        out = {"rank": rank, "end_step": st["end_step"],
               "signal_saves": st["signal_saves"], "dispatches": len(st["dispatches"]),
               "ms_step": 1e3 * st["loop_s"] / max(1, st["steps"]),
               "loop_agree_us": 1e6 * st["agree_s"] / max(1, len(st["dispatches"])),
               "agree_us": agree_us, "state": rank_summary(tr)["state_sha256"],
               "pieces_equal": pieces_equal}
        with open(os.path.join(tmp, f"sig{rank}.json"), "w") as f:
            json.dump(out, f)
        del tr
        import gc
        gc.collect()          # a chunk's graphs hold NCCL collectives
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        tdist.destroy_process_group()


def _wait_for(path, procs, timeout, what):
    t0 = time.perf_counter()
    while not os.path.exists(path):
        check(all(p.is_alive() for p in procs), f"{what}: a rank ended early")
        check(time.perf_counter() - t0 < timeout, f"{what}: waited {timeout} s")
        time.sleep(0.05)


def signal_ranks(world, backend, scan, tmp, data, device=None):
    """17b's ranks (``_rank17b``) as spawned processes: SIGUSR1 to rank 1's
    pid once it has made ``SIG_MARK`` dispatches, then SIGINT to rank 0's
    pid once the pause save is on disk. → (each rank's record, the tagged
    files, whether each holds the one-rank save's arrays bit for bit,
    seconds from SIGUSR1 to the pause on disk)."""
    import multiprocessing
    import signal

    import numpy as np

    from nerf_sandbox_tpu_torch.parallel.dist import free_port

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank17b,
                         args=(r, world, port, backend, tmp, data, scan, device))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        ck = os.path.join(tmp, "tp", "checkpoints")
        _wait_for(os.path.join(tmp, "mark1"), procs, 240, "17b")
        t_usr1 = time.perf_counter()
        os.kill(procs[1].pid, signal.SIGUSR1)
        while not any(f.startswith("pause_step_") for f in
                      (os.listdir(ck) if os.path.isdir(ck) else [])):
            check(all(p.is_alive() for p in procs), "17b: a rank ended before the pause")
            check(time.perf_counter() - t_usr1 < 120, "17b: no pause save in 120 s")
            time.sleep(0.05)
        pause_s = time.perf_counter() - t_usr1
        os.kill(procs[0].pid, signal.SIGINT)
        for p in procs:
            p.join(timeout=180)
        check(all(p.exitcode == 0 for p in procs),
              f"17b: the ranks' exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"sig{r}.json")) as f:
            recs.append(json.load(f))
    names = sorted(f for f in os.listdir(ck) if f.endswith(".ckpt")
                   and not os.path.islink(os.path.join(ck, f)))
    same = {}
    for name in names:
        got = _npz_arrays(os.path.join(ck, name))
        want = _npz_arrays(os.path.join(tmp, "onerank", name))
        same[name] = got.keys() == want.keys() and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want)
    return recs, names, same, pause_s


def check_signal_ranks(recs, names, same):
    """17b's checks: every rank saved at the same two steps and stopped at
    the second, with one state; the tagged files are those two, each the
    one-rank save of the gathered state, the interrupt save each rank's
    own tensors cut back into pieces. → (pause, interrupt)."""
    saves = [r["signal_saves"] for r in recs]
    ends = [r["end_step"] for r in recs]
    check(all(s == saves[0] for s in saves) and len(saves[0]) == 2,
          f"17b: the ranks saved at {saves}")
    pause, interrupt = saves[0]
    check(all(e == interrupt for e in ends), f"17b: the ranks stopped at {ends}")
    check(len({r["state"] for r in recs}) == 1, "17b: the ranks' states differ")
    check(names == tagged_names(pause, interrupt), f"17b: files {names}")
    check(all(same.values()) and sorted(same) == names,
          f"17b: not the one-rank save of the gathered state: {same}")
    check(all(r["pieces_equal"] is True for r in recs),
          f"17b: the interrupt save cut into pieces is not each rank's own: "
          f"{[r['pieces_equal'] for r in recs]}")
    return pause, interrupt


def phase_signals(torch, card):
    """17b: two ranks on card 0 over gloo, ``--mesh_model 2`` (with four
    cards 2 x 2 over NCCL, in captured chunks of 4), a signal sent to one
    rank's pid at a time (``signal_ranks``); every rank must save at the
    same step and stop at the same step, and each tagged file must hold
    what a one-rank trainer's save of the gathered state holds, bit for
    bit (``check_signal_ranks``)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    nccl = torch.cuda.device_count() >= 2 * TP_MODEL
    world, backend, scan = (2 * TP_MODEL, "nccl", 4) if nccl else (TP_MODEL, "gloo", 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sig_")
    try:
        data = os.path.join(tmp, "scene")
        images, K, c2ws = bench_frames()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        recs, names, same, pause_s = signal_ranks(world, backend, scan, tmp, data)
        print(f"[sig] 17b: {world} ranks over {backend} (data {world // TP_MODEL} x "
              f"model {TP_MODEL}, --scan_steps {scan}): SIGUSR1 to rank 1, SIGINT to "
              f"rank 0; signal saves per rank {[r['signal_saves'] for r in recs]}, end "
              f"steps {[r['end_step'] for r in recs]}, dispatches "
              f"{[r['dispatches'] for r in recs]}; files {names}; the pause on disk "
              f"{pause_s:.2f} s after SIGUSR1; {[round(r['ms_step'], 3) for r in recs]} "
              f"ms/step; the agreement alone {[round(r['agree_us'], 1) for r in recs]} "
              f"us, in the loop (sent after a dispatch, read after the next) "
              f"{[round(r['loop_agree_us'], 1) for r in recs]} us a dispatch | {card}",
              flush=True)
        check_signal_ranks(recs, names, same)
        print(f"[sig] 17b: {names} bit-equal to a one-rank trainer's save of the "
              f"gathered state, and the interrupt save cut into pieces bit-equal to "
              f"each rank's own; phase 17b took {time.perf_counter() - t_phase:.2f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank17c(rank, port, backend, data, out, limit, card, err, device=None):
    """17c, one ``--multihost`` process of two: card ``card`` under NCCL
    (the chunks of 8 captured with the gradient sum inside), card 0 under
    gloo; its stderr to the file ``err``; the heartbeat limit cut to
    ``limit`` seconds (the module constant, as the tests cut it); trains
    until the parent kills or stops a rank. On the card unless ``device``
    is "cpu" (the CPU rehearsal)."""
    fd = os.open(err, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    if backend == "nccl":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(card)
    import torch  # noqa: F401  (after the card is chosen)

    from nerf_sandbox_tpu_torch.parallel import dist
    from nerf_sandbox_tpu_torch.scripts.train_nerf import run
    dist.HEARTBEAT_TIMEOUT_S = limit
    dist.HEARTBEAT_EVERY_S = 1.0
    dist.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend=backend,
                              device=device, heartbeat=True)
    run(sig_argv(data, out, "--max_steps", str(SIG_STEPS), "--ckpt_every", str(HB_MARK),
                 "--scan_steps", "8" if backend == "nccl" else "1", "--multihost"),
        device=device)


HB_HOW = {"kill": "SIGKILL", "stop": "SIGSTOP"}


def heartbeat_ranks(backend, tmp, data, limit, n_cards=1, device=None):
    """17c's two pairs of processes (``_rank17c``), both at once: once rank
    0's checkpoint at ``HB_MARK`` is on disk, rank 1 of pair "kill" gets
    SIGKILL and rank 1 of pair "stop" SIGSTOP. Under NCCL each pair takes
    two cards, its own where there are four. → {pair: (rank 0's exit code,
    seconds from the signal to its exit, rank 0's stderr)}."""
    import multiprocessing
    import signal

    from nerf_sandbox_tpu_torch.parallel.dist import free_port

    ctx = multiprocessing.get_context("spawn")
    pairs = {}
    for i, how in enumerate(HB_HOW):
        base = 2 * i if n_cards >= 4 else 0
        out, port = os.path.join(tmp, how), free_port()
        errs = [os.path.join(tmp, f"{how}_rank{r}.err") for r in range(2)]
        pairs[how] = ([ctx.Process(target=_rank17c, args=(r, port, backend, data, out,
                                                            limit, base + r, errs[r],
                                                            device))
                       for r in range(2)], out, errs)
    every = [p for procs, _, _ in pairs.values() for p in procs]
    res, t_sig = {}, {}
    try:
        for p in every:
            p.start()
        for how, (procs, out, _) in pairs.items():
            _wait_for(os.path.join(out, "checkpoints", f"ckpt_{HB_MARK:07d}.ckpt"),
                      procs, 240, f"17c {how}")
            os.kill(procs[1].pid, getattr(signal, HB_HOW[how]))
            t_sig[how] = time.perf_counter()
        ended = {}
        while len(ended) < len(pairs):
            for how, (procs, _, _) in pairs.items():
                now = time.perf_counter()
                if how not in ended and (not procs[0].is_alive() or
                                         now > t_sig[how] + limit + HB_GRACE_S + 30):
                    ended[how] = now
            time.sleep(0.05)
        for how, (procs, _, errs) in pairs.items():
            with open(errs[0], errors="replace") as f:
                res[how] = (procs[0].exitcode, ended[how] - t_sig[how], f.read())
        return res
    finally:
        for p in every:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


def phase_heartbeat(torch, card):
    """17c: two pairs of ``--multihost`` processes (gloo on card 0; NCCL in
    captured chunks, one card each, with two cards or more), rank 1 of one
    killed and of the other stopped mid-run (``heartbeat_ranks``); each
    survivor must exit non-zero within the heartbeat limit plus
    ``HB_GRACE_S``, the stopped one's peer by its heartbeat, which prints
    ``HB_LINE`` (``survivor_verdict``): a stopped process keeps its
    sockets open, so gloo's own error on a closed connection cannot end
    its peer, and NCCL in a captured chunk has no timeout at all."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hb_")
    try:
        data = os.path.join(tmp, "scene")
        images, K, c2ws = bench_frames()
        write_blender_scene(data, images, K, c2ws,
                            {"train": [0, 1, 2], "val": [3], "test": [3]})
        res = heartbeat_ranks(backend, tmp, data, HB_LIMIT_S, n_cards)
        verdicts = {}
        for how, (code, seconds, err) in res.items():
            verdicts[how] = survivor_verdict(code, seconds, HB_LIMIT_S,
                                             stderr=err if how == "stop" else None)
            print(f"[hb] 17c: two --multihost processes over {backend}, rank 1 "
                  f"{HB_HOW[how]} after step {HB_MARK}: the survivor "
                  f"{verdicts[how][1]} | {card}", flush=True)
            if not verdicts[how][0]:
                print(f"[hb] 17c {how}: the survivor's stderr ends:\n{err[-3000:]}",
                      flush=True)
        print(f"[hb] phase 17c took {time.perf_counter() - t_phase:.2f} s", flush=True)
        for how, (ok, what) in verdicts.items():
            check(ok, f"17c {how}: the survivor {what}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_17(torch, card):
    """17: checkpoints and signals (17a, 17b, 17c)."""
    t_phase = time.perf_counter()
    phase_ckpt(torch, card)
    phase_signals(torch, card)
    phase_heartbeat(torch, card)
    print(f"[time] phase 17 took {time.perf_counter() - t_phase:.2f} s", flush=True)


def dp_inputs(torch, dev, root):
    """What phase 15 takes from phases 4 and 5, made as they make it: phase
    4's fine tile (frame 1's middle EVAL_CHUNK rays, 64 + 128 samples),
    phase 5's K2 frame 1 and its last-bin kink → (t4, frame1, kink)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    cfg, model_c, model_f = golden_models(torch, root, dev)
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]], np.float32)
    rays = get_camera_rays_grid(torch.from_numpy(Kmat).to(dev),
                                torch.from_numpy(blender_pose(1)).to(dev),
                                image_h=IMG, image_w=IMG, pixel_center=True)
    sl = slice(IMG * IMG // 2, IMG * IMG // 2 + EVAL_CHUNK)
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn, vd = rays.d_march_norm[sl].contiguous(), rays.d_world_unit[sl].contiguous()
    enc_dir = positional_encoding(vd, dir_bands)
    with torch.no_grad():
        zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(model_c, ro, rd, zc, rn, enc_dir, pos_bands)
        z = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                   deterministic=True)).contiguous()
    t4 = dict(ro=ro, rd=rd, rn=rn, vd=vd, z=z, zc=zc, enc_dir=enc_dir, Kmat=Kmat)
    tile = make_tile_renderer(EvalHyper(model=cfg, use_kernel=True), pos_bands,
                              dir_bands, device=dev)
    frame1 = render_pose(tile, model_c, model_f, blender_pose(1), IMG, IMG, Kmat,
                         eval_chunk=EVAL_CHUNK, device=dev)
    with torch.no_grad():
        enc_p = positional_encoding(
            rays.o_march + rays.d_march_unit * (6.0 * rays.d_march_norm), pos_bands)
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        kink, _ = last_bin_kink([(fm.fused_nerf_apply(m, enc_p, enc_d)[:, 3],
                                  m(enc_p, enc_d, compute_dtype=torch.bfloat16)[:, 3])
                                 for m in (model_c, model_f)])
    return t4, frame1, kink.reshape(IMG, IMG).cpu().numpy()


def device_line(torch):
    """Phase 1: print the card's name and count and ``nvidia-smi``'s name and
    power limit → (name, count, the nvidia-smi line)."""
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi gave no card")
    card = smi[0].strip()
    print(f"[device] {name} x{count} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return name, count, card


def run_dp(torch, root):
    """``--dp``: phases 15 and 16 alone on every card there is (15d, and
    16 over NCCL with 16f, with four cards or more), after the device line,
    the build and phase 15's inputs from phases 4 and 5 (phase 8's chunk
    figures not measured); prints their kernels-line rows and the card."""
    from nerf_sandbox_tpu_torch.ops import cuda_build
    name, count, card = device_line(torch)
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for "
          f"{sorted(report) or 'nothing (already built)'}", flush=True)
    dev = torch.device("cuda", 0)
    t4, frame1, kink = dp_inputs(torch, dev, root)
    kernels = {}
    launches = phase_dp(torch, dev, card, root, t4, frame1, kink, {}, kernels)
    launches.update(phase_tp(torch, dev, card, root, kernels))
    print(json.dumps({"kernels": [dict(k, launches=launches[key])
                                  for key, k in kernels.items()]}))
    check("nerf_sandbox_tpu" not in sys.modules and "jax" not in sys.modules,
          "the JAX package or JAX was imported")
    print(card)
    return name, count


def read_png_bytes(data: bytes, tmp):
    """Decode PNG bytes with the port's reader, through a file in ``tmp``."""
    from nerf_sandbox_tpu_torch.data.png import read_png
    path = os.path.join(tmp, "event_image.png")
    with open(path, "wb") as f:
        f.write(data)
    return read_png(path)


def run(torch, root):
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.device import resolve_device
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    t_run = time.perf_counter()
    figures = {}      # hierarchical figures of this run, printed beside phase 10's
    # ---- 1. device line ----
    dev = resolve_device("cuda")
    name, count, card = device_line(torch)

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for "
          f"{sorted(report) or 'nothing (already built)'}", flush=True)
    for src, rep in report.items():
        print(f"[build] {src}: {rep['seconds']:.2f} s", flush=True)
    build_notes(cuda_build)
    depths = ring_depths(cuda_build)
    check(all(depths.values()), f"a route holds fewer than two weight stages: {depths}")

    cfg = NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                     hidden_dim=256, skip_pos=4)
    sd = np.load(os.path.join(root, "tests", "golden", "mlp_state.npz"))
    model_f = NeRFMLP(cfg, device=dev)
    model_f.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    packed_f = fm.pack_nerf_params(model_f)
    macs = mlp_macs_per_row(cfg)
    kernels = {}

    # ---- 3. K1 against its plain version ----
    rng = np.random.RandomState(0)
    Q = EVAL_CHUNK * 64
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    got = fm.fused_nerf_apply(packed_f, ep, ed)
    want = fm.fused_nerf_apply_plain(packed_f, ep, ed)
    torch.cuda.synchronize()
    err = max_diff(got, want)
    check(torch.isfinite(got).all().item(), "K1 output not finite")
    check(err <= 0.05, f"K1 max |diff| {err} > 0.05")
    ms = cuda_ms(torch, lambda: fm.fused_nerf_apply(packed_f, ep, ed))
    plain_ms = cuda_ms(torch, lambda: fm.fused_nerf_apply_plain(packed_f, ep, ed))
    b_ms, b_by = bound(2.0 * macs * Q,
                       Q * (63 + 27) * 2 + packed_f.flat.numel() * 2 + Q * 4 * 4)
    kernels["fused_mlp"] = dict(
        name="fused_mlp", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_mlp.cu",
        replaces="nerf_sandbox_tpu/ops/fused_mlp.py:162", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[K1] Q={Q} max|diff|={err:.3g} (tol 0.05) kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
    fetch_line("K1", ms, b_ms, -(-Q // fm.TILE_M), packed_f, card)
    ep_pad = fm.pad_cols_bf16(ep, 64)
    ed_pad = fm.pad_cols_bf16(ed, 32)
    chain = mlp_chain_bf16(torch, packed_f, ep_pad, ed_pad)
    chain_err = max_diff(chain.float(), want)
    chain_ms = cuda_ms(torch, lambda: mlp_chain_bf16(torch, packed_f, ep_pad, ed_pad))
    print(f"[K1] yardstick, not used by the port: the same MLP as a chain of bf16 "
          f"cuBLAS calls layer by layer (addmm / mv, bf16 between layers) "
          f"{chain_ms:.3f} ms at Q={Q} (max|diff| vs plain {chain_err:.3g}); K1 "
          f"{ms:.3f} ms = {chain_ms / ms:.2f}x faster | {card}", flush=True)

    # ---- 4. K2 against its plain version, on a real eval tile ----
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]],
                    np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(blender_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    sl = slice(IMG * IMG // 2, IMG * IMG // 2 + EVAL_CHUNK)   # mid-frame tile
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn, vd = rays.d_march_norm[sl].contiguous(), rays.d_world_unit[sl].contiguous()
    enc_dir = positional_encoding(vd, dir_bands)
    with torch.no_grad():
        zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(model_c, ro, rd, zc, rn, enc_dir, pos_bands)
        z = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                   deterministic=True)).contiguous()
    B, N = z.shape
    kw = dict(pos_include_input=True, sigma_activation="relu", white_bkgd=True)
    got = fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir, pos_bands)
    dt = fr._deltas(z, rn, True)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, **kw))
    torch.cuda.synchronize()
    names = ("comp", "w", "acc", "depth")
    # Rays at the last-bin kink (see last_bin_kink) are held on every sample
    # weight but the last; all other rays on every output.
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(packed_f, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(packed_f, enc_last, enc_dir)[:, 3])])
    ok = ~kink
    errs = {n: max_diff(g[ok], w[ok]) for n, g, w in zip(names, got, want)}
    errs["w[:-1]"] = max_diff(got[1][:, :-1], want[1][:, :-1])
    n_kink = int(kink.sum())
    print(f"[K2] tile {B}x{N}: max|diff| vs plain {errs}; {n_kink} rays at "
          f"the last-bin kink (|logit| < {bands[0]:.3g}), whole-tile comp "
          f"max|diff| {max_diff(got[0], want[0]):.3g}", flush=True)
    check(n_kink <= 0.05 * B, f"K2: {n_kink} of {B} rays at the last-bin kink")
    for n, tol in zip(names + ("w[:-1]",), (2e-2, 2e-2, 2e-2, 0.1, 2e-2)):
        check(np.isfinite(errs[n]) and errs[n] <= tol,
              f"K2 {n} max |diff| {errs[n]} > {tol}")
    # ERT on the tile, and on a dense variant of the model (sigma bias +10)
    # where every ray saturates and whole blocks stop early.
    model_d = NeRFMLP(cfg, device=dev)
    model_d.load_state_dict(model_f.state_dict())
    with torch.no_grad():
        model_d.sigma_out.bias += 10.0
    packed_d = fm.pack_nerf_params(model_d)
    ert_ms = {}
    for tag, pk in (("golden", packed_f), ("dense", packed_d)):
        full = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
        ert = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                ert_eps=1e-4)
        ert_errs = {n: max_diff(g, w) for n, g, w in zip(names, ert, full)}
        ert_ms[tag] = (
            cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                     pos_bands)),
            cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                     pos_bands, ert_eps=1e-4)))
        print(f"[K2] ERT(1e-4) vs none, {tag} model: max|diff| {ert_errs}; "
              f"{ert_ms[tag][0]:.3f} ms without, {ert_ms[tag][1]:.3f} ms with",
              flush=True)
        for n in names:
            check(np.isfinite(ert_errs[n]) and ert_errs[n] <= 1e-3,
                  f"K2 ERT ({tag}) {n} max |diff| {ert_errs[n]} > 1e-3")
    ms = ert_ms["golden"][0]
    plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, **kw))
    coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, ro, rd, zc, rn, enc_dir, pos_bands))
    b_ms, b_by = bound(2.0 * macs * B * N,
                       B * (7 + 27) * 4 + B * N * 4 * 3 + B * 5 * 4
                       + packed_f.flat.numel() * 2)
    kernels["fused_raymarch"] = dict(
        name="fused_raymarch", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[K2] fine tile kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); coarse "
          f"tile {B}x{zc.shape[1]} kernel {coarse_ms:.3f} ms", flush=True)
    b_coarse_ms = bound(2.0 * macs * B * zc.shape[1], 0.0)[0]
    fetch_line("K2 fine", ms, b_ms, mlp_passes(B, N), packed_f, card)
    fetch_line("K2 coarse", coarse_ms, b_coarse_ms, mlp_passes(B, zc.shape[1]),
               packed_f, card)

    # ---- 4b. the 360 configuration: K2c, K3 and K3t on one fine tile ----
    ctx360 = phase_360_tile(torch, dev, card, packed_f, kernels)

    # ---- 4c. K4, the IPE encode, on the Blender and 360 fine tiles ----
    t4 = dict(ro=ro, rd=rd, rn=rn, vd=vd, z=z, zc=zc, enc_dir=enc_dir, Kmat=Kmat)
    ctx_ipe = phase_ipe_tile(torch, dev, card, packed_f, packed_d, t4, ctx360,
                             kernels)

    # ---- 5. the slice: render_pose through K2, nerf_forward_pass through K1 ----
    hyper = EvalHyper(model=cfg, use_kernel=True)
    tile_k = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fm.fused_nerf_apply.launches = 0
    fr.reset_launches()
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, blender_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK,
                                  device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, ro, rd, z, pos_bands=pos_bands,
                                dir_bands=dir_bands, white_bkgd=True,
                                ray_norms=rn, viewdirs_world_unit=vd,
                                infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_mlp": fm.fused_nerf_apply.launches,
                "fused_raymarch": routes["freq"]}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    print(f"[slice] launches on the main path: {launches}, K2 routes {routes} "
          f"(K2 expected {2 * n_tiles * N_POSES})", flush=True)
    check(fr.fused_raymarch.launches == routes["freq"] == 2 * n_tiles * N_POSES,
          f"K2 launched {fr.fused_raymarch.launches} times ({routes}), expected "
          f"{2 * n_tiles * N_POSES} frequency launches")
    check(routes["kplanes"] == routes["contract"] == routes["ipe"] == 0,
          f"the Blender path ran another K2 instantiation: {routes}")
    check(launches["fused_mlp"] >= 1, "K1 was not launched on the main path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"frame {k} {key} not finite")
        check(f["rgb"].shape == (IMG, IMG, 3), f"frame {k} rgb shape")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"frame {k} rgb outside [0, 1]")
        check(f["acc"].min() >= 0.0 and f["acc"].max() <= 1.0,
              f"frame {k} acc outside [0, 1]")
    fwd_err = max_diff(fwd[0][ok], got[0][ok])
    print(f"[slice] nerf_forward_pass(use_kernel=True) vs K2 on the tile, off "
          f"the kink: comp max|diff| {fwd_err:.3g}", flush=True)

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, blender_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # Both passes end on a sample at z = far: pixels whose coarse or fine
    # last logit is too close to zero to call are held by the frame PSNR.
    with torch.no_grad():
        enc_p = positional_encoding(
            rays.o_march + rays.d_march_unit * (6.0 * rays.d_march_norm), pos_bands)
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        kink, bands = last_bin_kink([
            (fm.fused_nerf_apply(m, enc_p, enc_d)[:, 3],
             m(enc_p, enc_d, compute_dtype=torch.bfloat16)[:, 3])
            for m in (model_c, model_f)])
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k2_frame_s = n_tiles * (coarse_ms + ms) / 1e3
    figures.update(frame_s=s_frame, k2_fine_ms=ms, k2_coarse_ms=coarse_ms)
    print(f"[slice] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice] K2 share of a frame: {n_tiles} x (coarse {coarse_ms:.3f} + "
          f"fine {ms:.3f} ms) = {k2_frame_s:.3f} s of {s_frame:.3f} s "
          f"({100 * k2_frame_s / s_frame:.1f}%)", flush=True)
    print(f"[slice] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")
    # one more frame under the profiler (after the counts were read)
    traced = profile_frame(torch, lambda: render_pose(
        tile_k, model_c, model_f, blender_pose(1), IMG, IMG, Kmat,
        eval_chunk=EVAL_CHUNK, device=dev), "slice profile", card)
    if traced is not None:
        print(f"[slice profile] K2 in the trace: {traced[0]:.3f} s of the profiled "
              f"{traced[1]:.3f} s frame ({100.0 * traced[0] / traced[1]:.1f}%)",
              flush=True)

    # ---- 5b. the 360 slice: render_pose through K2c + K3 ----
    launches_360 = phase_360_slice(torch, dev, card, ctx360)

    # ---- 5c. the IPE slice: render_pose through K4 ----
    launches_ipe = phase_ipe_slice(torch, dev, card, model_c, model_f, t4, ctx_ipe)

    # ---- 3w, 4w, 5w. hidden widths 384 and 512: K1 and K2's wide path ----
    launches_wide = phase_wide(torch, dev, card, t4, kernels)

    # ---- 3x, 4x, 5x. hidden widths above 512: the large route ----
    launches_large = phase_large(torch, dev, card, t4, kernels)

    # ---- 4b4, 5b4. the 360 configuration with 4-feature planes ----
    launches_kp4 = phase_kp_narrow(torch, dev, card, ctx360, kernels)

    # ---- 7. K5, the precision probe ----
    launches_probe = phase_precision_probe(torch, dev, card, kernels)

    # ---- 8. the training step, bench.py's recipe ----
    bare_ms = phase_train(torch, dev, card, figures)

    # ---- 9. the CLI: train, validate, checkpoint, resume, render ----
    launches_cli = phase_cli(torch, card, bare_ms, figures)

    # ---- 10c. an occupancy Blender frame; the sampling modes' figures ----
    phase_occupancy_frame(torch, dev, card, model_f, Kmat, figures)
    print_sampling_figures(figures, card)

    # ---- 11. the README's Quickstart: Blender and fern ----
    launches_qs = phase_quickstart(torch, card, figures, frames)

    # ---- 11c. fern from JPEGs past baseline ----
    phase_jpeg_tail(torch, card)

    # ---- 12. slice 9: SH directions, appearance codes, camera refinement ----
    t0 = time.perf_counter()
    launches_s9 = phase_slice9_tiles(torch, dev, card, t4, kernels)
    launches_s9.update(phase_slice9_cli(torch, card, figures))
    phase_slice9_chunk(torch, dev, card, figures)
    print(f"[time] phase 12 took {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 13. held-out evaluation, refiners and mesh export ----
    launches_eval = phase_eval(torch, dev, card, t4, kernels)

    # ---- 14. --encoder hashgrid ----
    launches_hash = phase_hash(torch, dev, card, kernels, figures)

    # ---- 15. data parallel over rays ----
    launches_dp = phase_dp(torch, dev, card, root, t4, frames[1], kink, figures,
                           kernels)

    # ---- 16. tensor parallel over a model axis ----
    launches_tp = phase_tp(torch, dev, card, root, kernels)

    # ---- 17. checkpoints and signals ----
    phase_17(torch, card)

    print(f"[time] phases 1-17 took {time.perf_counter() - t_run:.2f} s", flush=True)

    # ---- 6. kernels line ----
    for key, k in kernels.items():
        k["launches"] = next(d[key] for d in (launches_qs, launches_s9, launches_eval,
                                              launches_hash, launches_dp, launches_tp,
                                              launches_cli,
                                              launches,
                                              launches_360,
                                              launches_ipe,
                                              launches_wide, launches_large,
                                              launches_kp4, launches_probe)
                             if key in d)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order}
                                  for k in kernels.values()]}))
    check("nerf_sandbox_tpu" not in sys.modules and "jax" not in sys.modules,
          "the JAX package or JAX was imported")
    print(card)
    return name, count


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "nerf_sandbox_tpu_torch")):
        print("chip_smoke: the nerf_sandbox_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    if sys.argv[1:] not in ([], ["--dp"], ["--scatter-parts"]):
        print("usage: chip_smoke.py [--dp | --scatter-parts]", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--scatter-parts"]:
        scatter_parts_child(torch)
        return 0
    try:
        if sys.argv[1:] == ["--dp"]:
            name, count = run_dp(torch, root)
        else:
            name, count = run(torch, root)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        import shutil
        for d in WORK_DIRS:
            shutil.rmtree(d, ignore_errors=True)
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
