#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line {"phase", "ok", "elapsed_s", ...}:

1. device  -- needs torch.cuda; prints the nvidia-smi name/power-limit line.
2. build   -- builds the fused_mcm CUDA kernel with nvcc (ctypes-bound).
3. grad    -- one stage (stage 1: four scales, 16 channels) at batch 64 in
              fp32 through fused_mcm on the card: its outputs carry a
              grad_fn, and its gradients for xs, whs, wvs and bs match
              autograd through mcm_ref (max abs error <= 1e-4 * max|ref|).
4. kernel  -- for each of the flagship's eight MultiscaleConvMax stage
              shapes at the serving batch, holds the kernel against its
              plain version mcm_ref in fp32 (TF32 off; max abs error <=
              1e-4 * max|ref|) and bf16 (<= 2e-2 * max|ref|), and times the
              kernel, mcm_ref and the cuDNN conv sequence mcm_ref makes,
              per call from Python (`ms`; `launch_ms` the launches alone,
              without the autograd Function and the mcm_stage operator's
              dispatch) and on the device alone (CUDA graph replay,
              `device_ms`);
              four shapes off the flagship's path are checked too (widths
              12/6/3 at batch 7; output widths 12, 20 and 160; input
              channels 3, 4 and 24; printed as `kernel_off_path`), and
              stages 4-7 at batch 32 (the routed engine's deep buffers) are
              checked and timed in bf16. Each bf16 stage's error against
              mcm_ref run in fp32 on the same bf16-valued inputs is printed
              (not a gate). The fp32 kernel (3xTF32 on the tensor cores)
              is also held against mcm_ref in float64 on the same inputs
              at batch 128 and on the off-path shapes: max abs error <=
              1e-5 * max|ref| (F64_TOL), printed beside fp32 mcm_ref's own
              error against float64. Each line has the stages' summed
              device times and the kernel's ratios to cuDNN (`vs_cudnn`)
              and to its bound (`vs_bound`; fp32 at the 3xTF32 rate).
   kernel_nets -- the kernel's net axis (mcm_scale_forward_nets): the
              eight stages for the sweep's 8 nets at batch 128, fp32 and
              bf16, stage 0's input shared, through torch.func.vmap of
              fused_mcm (one launch per output scale for all nets),
              against mcm_ref on each net's slice at the kernel phase's
              tolerances; in fp32 every net's outputs must equal a
              single-net launch on its tensors bit for bit, and be within
              F64_TOL of mcm_ref in float64 on each net's slice. Times: the
              vmapped call (`ms`, `device_ms`), mcm_ref net after net
              (`plain_*`) and mcm_ref under the same vmap (`library_*`,
              cuDNN's grouped convs), beside the bound of 8 nets' work.
   kernel_tails -- the same for the tree's tail stages 3-7, every input
              batched, at 8 x batch 128 (the stacked tails of one tree)
              (fp32 and bf16) and 64 x batch 128 (8 trees x 8 tails of
              the sweep with stacked tails; fp32).
5. serve   -- reads the trained flagship checkpoint onto the GPU and runs
              routed inference (the port's main path) at capacity 1.0 and at
              calibrated capacities: first in fp32, kernel path against the
              same net through mcm_ref, then in bf16 (the main path) over
              5 timed windows of 20 batches per capacity, with img/s (median
              and spread of the windows) and mean realized ops per example.
              The kernel's launch count is set to 0 just before the bf16
              serving and read just after; it must have risen. Before it,
              bf16 dense serving through the kernel is compared with the
              mcm_ref path: the exits that differ, and how many of them
              have a deciding router margin below 1e-2, are printed (not a
              gate).
6. train   -- the training step of the flagship actor chain, built fresh
              from seed 0, at batch 128 (`make_train_step`: augmentation,
              forward, routing, actor loss, gradients, TALR, momentum):
              train_fp32_vs_plain takes one step from the same sampled and
              augmented batch through the kernel and through mcm_ref
              (patched in as serve() does) in fp32 and holds the loss (1e-5
              relative), the BatchNorm running statistics (1e-4 in
              ||kernel - plain|| / ||plain|| per leaf), the gradients and
              the parameters after the step (1e-3 in the same norm over
              the whole tree, 5e-2 per leaf: see TRAIN_TOL; the biases
              right before a train-mode BatchNorm, whose exact gradient is
              zero, must be below 1e-6 of the tree's norm on both paths)
              against each other, with exactly 20 kernel launches per
              forward (the stages' L sum to 20; the backward launches
              none); the same comparison for a float64 stage rounded to
              fp32 is printed as the yardstick of rounding alone.
              train_bf16_vs_fp32 takes one step four ways from the same
              params and batch (kernel and mcm_ref, bf16 and fp32): the
              kernel path's bf16 gradients may be at most 2x as far from
              its fp32 gradients, over the whole tree, as mcm_ref's bf16
              gradients are from mcm_ref's fp32 ones (every distance is
              printed). train_fp32 and train_bf16 then each take 2 timed
              windows of 10 steps (img/s, median and every window; the
              loss finite at each window's end); the kernel's count is set
              to 0 before each and must read 20 per step after it; then 2
              steps under torch.profiler give the device's time,
              operations and idle share per step. bf16 also prints the
              kernel path's first-step loss against the mcm_ref path's
              (not a gate).
              The kernel phase holds and times the eight stages at the
              training batch 128 too, fp32 and bf16.
7. sweep   -- the vmapped k_cpt sweep (make_sweep_train_loop) of 8
              flagship actor chains at batch 128 per net:
              sweep_fp32_vs_plain takes one fp32 sweep step through the
              net axis and through mcm_ref and holds it to
              train_fp32_vs_plain's gates over the stacked trees (the
              losses per member; the worst member's errors and a float64
              stage's are printed), with
              exactly 20 launches per sweep forward and none in the
              backward; sweep_train_fp32 and sweep_train_bf16 take 2 timed
              windows of 10 steps each (aggregate img/s of all nets,
              median and every window, beside the single-net rate of the
              train phase of the same run), the counts from 0 and 20
              net-axis launches a step; sweep_train_bf16 also holds one
              sweep step to train_bf16_vs_fp32's gate.
7a. repeat -- the fp32 flagship's serial train loop and the 8-net
              sweep's loop, 3 steps twice from one state, in three modes
              (default; cudnn.deterministic; that and
              torch.use_deterministic_algorithms, warn_only): per tree
              (params, state, velocity) the leaves that differ and the
              worst member's relative error, and the ops that warn
              (ROADMAP C1; not a gate); both loops' img/s in 2 windows
              each (10 serial steps, 5 sweep steps), default and
              deterministic in turns; the cost of
              check_nans (`train --debug-nans`) on their trees.
7b. trees  -- the 47-stage actor tree (`ac_tree(k_cpt=k_cpts[4])`, fresh
              from seed 0, batch 128): tree_train_fp32_vs_plain holds one
              fp32 step at train_fp32_vs_plain's gates with 96 launches
              per forward; tree_train_fp32 / tree_train_bf16 take 2
              windows of 3 steps (img/s beside the chain's of this run; 1
              profiled step, fp32 only); tree_sweep_train_fp32 holds one
              step of synth-ac-tree's 8 trees at the sweep gates (96
              net-axis launches per sweep forward) and, with
              tree_sweep_train_bf16, times 2 windows of 1 step (aggregate
              img/s; 1 profiled step, fp32 only).
7c. stacked tails -- ops.config.stacked_tails (`--stacked-tails`): the
              tree's eight congruent tails as one vmapped template, the
              trees packed as the loops carry them. tree_stacked_vs_serial
              holds one fp32 step of the fresh actor tree at batch 128
              against the serial step, both through the kernel, and
              against the stacked step through mcm_ref, at
              train_fp32_vs_plain's gates, with 33 launches per forward
              (24 of one net, 9 on the net axis); tree_stacked_train_fp32
              / _bf16 time it as tree_train_* does, beside the serial
              tree's img/s, operations and idle share of 7b;
              tree_sweep_stacked holds one step of the 8 trees (each
              tree's tails a vmap inside the sweep's: 33 net-axis
              launches per sweep forward, the tails 64 wide) at the sweep
              gates against mcm_ref, then times 2 windows of 1 step
              beside the serial sweep of 7b.
7d. tree serving -- the trained adaptive tree
              (results/nets/hybrid-ac-tree-dynkcpt/net.npy.cz, its
              committed compact form: bfloat16 weights) serves the test
              split of hybrid.npz, rebuilt at full size (50,000 / 2,000) by
              the port's prep, at batch 1024 and each of the 8 k_cpts,
              dense and at capacities calibrated on the train split: fp32
              through the kernel against mcm_ref (probs within 1e-4, the
              same exits, ops and forced counts outside router near-ties
              on the example's path), then bf16 timed (2 windows of 1
              pass over the padded test split, dense and routed in
              turns; the kernel's count from 0), with the bf16 exits that
              differ from fp32's.
7e. serving artifacts --
              export_chain: the trained flagship traced with torch.export
              (mpnn_tpu_torch.export) at batch 1024 in bf16 at
              serve_bf16's calibrated capacities, saved, loaded and served
              on two synthetic batches against the direct engine (exit_idx,
              ops and forced equal, probs within 1e-5, 20 launches a
              batch, counted from 0 per batch), img/s of the artifact and
              the engine in turns (2 windows of 10 batches); an fp32 export
              at batch 64 moved to the CPU against the CPU engine (exits
              outside router near-ties, probs within 1e-4).
              export_adaptive: results/nets/hybrid-ac-dynkcpt/net.npy as
              one dyn_k_cpt artifact (capacities calibrated at price 0)
              served at the 8 prices on the rebuilt hybrid.npz's first
              test batch against the engine, 20 launches a batch, mean ops
              at the dearest price at most at price 0. Each with its
              seconds, file bytes and load seconds.
7f. phases that time no rate, side by side -- seven things run in
              processes of their own: the dry run (22), export_chain's
              artifact served by a fresh process, check_parity's CLI,
              export_tree and train_cli (8) (each `python3 chip_smoke.py
              --phase-process NAME DIR`), the adaptive trainer's CLI (9)
              and the mesh CLIs (18, 19; checked after dp_nccl);
              meanwhile this process runs tree_desc_vs_jax_files, compact
              and phases 10, 11, 13-15. Their seconds are not one phase's
              alone (the img/s of train_cli's runs included). Then each
              process is waited for and checked: parity after zoo_train,
              then train_cli, export_tree, export_process, dryrun and
              adaptive_cli after prep_files. export_tree: the trained tree exported as
              export_adaptive's chain is, 96 launches a batch (counted in
              its process), with its export and load seconds. tree_desc_vs_jax_files
              prints, at the two ends of the price range (TREE_DESC_K),
              net_desc of the trained tree through the kernel (fp32, eval
              batch 1024) beside the descriptor files its training wrote
              (accuracy, moc, the largest difference of a scalar stat; not
              a gate), and, where the fp32 net.npy is in the checkout,
              net_desc of that beside both. compact: the tree's archive
              read, rewritten by write_compact and read back bit for bit;
              the net decoded from it (params bit for bit) serves a batch
              with the original's exits (probs within 1e-5). parity:
              check_parity and check_grad_parity of the flagship on the
              first 8 test images, fp32 on the kernel path, ok, 20
              launches a forward; under bf16 check_parity must fail;
              `python -m mpnn_tpu_torch.check_parity --grads` as a
              process: exit 0, PARITY OK. export_process: the artifact,
              served by a process that cannot import jax, mpnn_tpu or the
              port's models, utils and experiments, gives the direct
              engine's outputs with 20 launches. Phase 12 runs before
              these, after 7e.
8. train_cli -- the training CLI's path (`train.train_experiment`, as
              `python -m mpnn_tpu_torch.train` runs it) in a temporary
              directory, fp32, batch 128, t_log 20, on the small synthetic
              archives of the port's prep: synth-ac net 4 for 40
              iterations, then resumed to 60; synth-sr net 7 (the 8-stage
              SR chain) and synth-cr net 4 for 20 each. The kernel's count
              starts from 0 before the first run; each run must launch it
              exactly per_forward x (steps + evaluations x eval batches),
              with per_forward summed over the net's MultiscaleConvMax
              layers. Checks: every file of the output contract exists;
              each final checkpoint, read back, equals the live params,
              state and momentum bit for bit, with t = n_iter; the resumed
              run starts at 40; the final synth-ac checkpoint's net_desc
              through the kernel agrees with it through mcm_ref within
              1e-4 * max(1, |stat|) on every scalar stat (the worst stat
              is printed). Then synth-ac --vmap-sweep to 40 and resumed to
              60 (all 8 nets at once, another output root), held the same
              way for every net, with 20 launches per sweep forward, and
              net 4's final descriptor from the sweep's vmapped
              evaluation through the kernel against net_desc of its
              checkpoint through mcm_ref. synth-ac-tree net 4 and
              synth-ac-tree --vmap-sweep run to 10 under the same checks
              (96 launches per forward). Prints each run's seconds and
              img/s over training alone and over training, evaluation and
              writes. The phase runs with deterministic algorithms, as
              the CLI does on the card (`set_up_device`), and adds
              synth-ac net 4 from 0 to 60 in one run with --profile-dir
              and --debug-nans (gate 0 of ROADMAP C1): its files,
              checkpoint and stats equal the run resumed at 40 bit for
              bit; its Chrome trace holds 8 steps and names
              mcm_scale_tf32; its launches are 20 x (60 steps + 3
              evaluations x 6 batches); then a NaN forced into a param of
              its checkpoint makes one step under debug_nans raise
              FloatingPointError naming step 60.
9. adaptive_cli -- `python -m mpnn_tpu_torch.train_adaptive` in processes
              of its own, in phase 7f (ADAPTIVE_RUNS:
              synth-ac-tree-dynkcpt to 5 with t_log 5 and --stats-log,
              resumed to 10 in a copy of its output root, and
              synth-cr-dynkcpt to 5; and the first run again with
              --stacked-tails into another output root; the runs from
              scratch at once, then the resume): the files (the
              stacked run's file set the serial run's), net.npy read back
              bit for bit with its step, the resume's start, each
              process's launches and net-axis launches (its last line)
              against per_forward x (steps + evaluations x eval batches),
              and the tree's descriptor files, serial and stacked, against
              net_desc through mcm_ref (1e-4 x max(1, |stat|)).

10. zoo_layers -- each layer of the rest of the zoo forward and backward
              on the card against the same layer on the CPU, fp32, batch
              128 (Conv 3x3 16->32 with and without res, MaxPool supp 3
              stride 2 in both modes, GlobalMaxPool, MultiscaleLLN on the
              4-scale pyramid, SquaredError, SuperclassCrossEntropyError
              with w_cls 10->2, ActivityError): outputs and loss terms
              within 1e-5 x max|ref|, gradients within 1e-4; Dropout at
              λ = 0.5 on 1024 x 32 x 32 x 10 elements: the kept share
              within 0.5% of λ, the same (stream, uid) the same mask, the
              two members of a stacked group different masks.
11. tf1_pyramid -- ToPyramid at batch 1024 under pyramid_tf1 on the card
              equals the CPU's scales and x[:, ::2^k, ::2^k] exactly.
12. reference_import -- the full-width 8-deep actor chain in the
              reference's exact schema (tests/tf1_ckpt_gen.py) read by the
              port's read_net under pyramid_tf1: a batch of 1024 served
              dense through the kernel against mcm_ref at the serving
              gates with 20 launches a forward (counted from 0), one step
              at batch 128 at the step gates, and bf16 dense img/s (5
              windows of 20 batches).
13. zoo_train -- the flagship's first three stages as an actor chain that
              uses every new layer (MultiscaleLLN after ToPyramid, the
              leaf Select -> Conv -> Rect -> MaxPool -> Dropout(0.5) ->
              GlobalMaxPool -> LinTrans -> Softmax -> SquaredError at
              stages 0 and 1, ActivityError and a superclass leaf at stage
              2): one fp32 step through the kernel against one through
              mcm_ref with the same Dropout masks, at the step gates with
              11 launches a forward, serially and with stacked tails (the
              two zoo leaves one group); remat "full" and "dots" against
              none, gradients within 1e-5 over the tree, each with its
              peak device memory and its launches: "dots" saves the
              mcm_stage operator's outputs, so it launches as none does
              (11 a step), "full" recomputes (22).
14. tf1_cli -- `train synth-ac --net 4 --pyramid-tf1` and `train_adaptive
              synth-ac-dynkcpt --pyramid-tf1 --maxpool-tf1` to 20 steps
              in this process on the small archives, fp32, batch 128:
              the files, and launches (counted from 0 for each) = 20 x
              (steps + evaluations x eval batches).
15. prep_files -- real-format fixtures (a scipy .mat of 300 / 50 digits
              a class, the cifar-10-batches-mat gztar of 300 rows a
              batch) through the port's prepare_from_files, then `train
              hybrid-ac --net 4` to 20 steps from the hybrid.npz it wrote,
              its launches checked the same way; the six phases' seconds.

16. dp_train -- the flagship at k_cpts[4], global batch 128, fp32, over a
              data mesh of 2 ranks, each a process of its own on the card
              (gloo: NCCL refuses two ranks on one GPU), 64 rows each:
              one step against the single-process kernel step at the
              step gates, the ranks' params equal after it, 20 launches a
              forward on each rank; then 2 windows of 5 steps: img/s over
              the global batch, all-reduces a step and their host time,
              each rank's launches counted from 0 in its process. The
              kernel's eight stages at batch 64 against mcm_ref and
              float64.
17. dp_nccl -- this process as a world of one rank over NCCL (its data
              axis's all-reduces run): one step against the meshless step
              at the step gates, and which parts are equal bit for bit.
18. sweep_mesh -- `python -m mpnn_tpu_torch.train synth-ac --vmap-sweep
              --mesh 2x1` (the CLI starts 2 ranks, 4 nets each; started
              together with mesh_cli's run, in 7f) against the same
              meshless sweep in this process, one step on the small
              archive: every member's files, params at the step gates, descriptors within 1e-4 x max(1, |stat|), each log
              written once, each rank's net-axis launches (its closing
              JSON line) = 20 x (steps + eval batches); the net axis at 4
              nets x 128 against mcm_ref.
19. mesh_cli -- `python -m torch.distributed.run --nproc-per-node 2 -m
              mpnn_tpu_torch.train synth-ac --net 4 --multihost --mesh
              auto` against `train synth-ac --net 4` in this process, the
              same checks.
20. sweep_remat -- one step of the 8-net sweep under remat "full" and
              "dots" against none at the step gates: launches (40 / 20 /
              20 a loss and gradient) and peak device memory.
21. tp_train -- the flagship at k_cpts[4], global batch 128, fp32, over
              a 1x2 and a 2x2 ('data', 'model') mesh of ranks sharing the
              card over gloo (one start of 4 ranks; ranks 2 and 3 wait
              while 0 and 1 run the 1x2 mesh), params and velocity
              sharded over 'model' by shard_params(model_parallel=True,
              min_chan=64) (the 8 weight leaves of stages 4-7): one step
              against the single-process kernel step at the step gates,
              the ranks' whole params equal after it, 20 launches a
              forward on each rank, 6 of them at sharded shapes (every
              launch's shape as expected); 2 windows of 4 steps: img/s,
              the collectives a step over 'model' and over 'data' and
              their host time, each rank's launches counted from 0 in its
              process. The sharded
              launch shapes at a rank's batch (128, 64) against mcm_ref
              (and the block of the whole stage) and float64, timed
              against mcm_ref and the cuDNN sequence, with their bound.
              On 1x2 also the actor tree with stacked tails, sharded the
              same way: one step against the single-process stacked
              step at the step gates, the ranks' whole params equal, 33
              launches a forward (9 on the net axis, some of them from a
              per-net gathered prev); and the sharded shapes on the net
              axis (vmap of fused_mcm_scale over 8 nets at batch 128)
              against mcm_ref and float64, timed.
22. dryrun -- `python -m mpnn_tpu_torch.dryrun 4`: phase 1 on the 2x2
              dp x tp mesh, phase 2 on the sweep mesh, on the card; its
              4 ranks run beside the phases of 7f, which time nothing,
              and are waited for before any timed phase; killed, with
              the other processes of 7f, if a check fails first.

Then one {"kernels": [...]} line, the kernel (bf16), its fp32 branch
(launches on the fp32 training main path) and its net axis (with the
training main paths' launches in `train_launches`, `sweep_launches` and
the CLI path's in `train_cli_launches`, `train_cli_sweep_launches`; the
tree paths' in `tree_launches` and `tree_sweep_launches`; the stacked
tails' in `tree_stacked_launches` and `tree_sweep_stacked_launches`, the
tail stages' times in `tail_stages`; the paths of phases 12-15 in
`tf1_launches`; each rank's on the mesh paths in `mesh_launches`,
`tp_launches` (the sharded scales' times in `tp_scales`),
`sweep_mesh_launches_per_rank` and `sweep_remat_launches`), and last the
device record. Any failed phase, rank or collective raises and the script
exits non-zero; it also exits non-zero, with no result, where CUDA is
absent or the port's package is not beside it."""

import contextlib
import json
import math
import os
import statistics
import sys
import time
from unittest import mock

import numpy as np

# The training CLIs run with deterministic algorithms on the card
# (`mpnn_tpu_torch.set_deterministic`), whose cuBLAS setting must be in
# place before the process's first cuBLAS handle; train_cli and
# repeat_phase turn them on in this process.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))

TOL = {"fp32": 1e-4, "bf16": 2e-2}  # max abs error / max|ref|
# The fp32 kernel (3xTF32) against mcm_ref in float64 on the same inputs:
# fp32's own error is ~4e-7 of max|ref|, plain TF32's ~3e-4.
F64_TOL = 1e-5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CHECKPOINT = os.path.join(HERE, "results", "nets", "hybrid-ac", "0004.npy")
BATCH = 1024  # the serving batch, also the kernel check's batch
ROUTED_BATCH = 32  # rows of the routed engine's deep buffers
TRAIN_BATCH = 128  # the per-net training batch of bench.py
GRAD_BATCH = 64
N_TRAIN_STEPS = 10  # steps per timed training window
# One fp32 train step, kernel path against mcm_ref path. The loss and the
# BatchNorm statistics are continuous in the forward's rounding and are
# held per leaf. The gradients (and the parameters they move) are not: a
# few ReLU and 2x2 max-pool decisions flip between two fp32 forwards that
# round differently, and each flip moves deep-stage gradient leaves by up
# to ~1e-3. The phase prints the same comparison for a float64 stage
# rounded to fp32 (more exact, not wrong) as the yardstick. So gradients
# and parameters are held as a whole tree and, per leaf, to a bound that a
# wrong leaf exceeds; the count of leaves past 1e-4 is printed.
TRAIN_TOL = {"loss": 1e-5, "state": 1e-4, "tree": 1e-3, "leaf": 5e-2,
             "zero_grad": 1e-6}
DISCRETE_TOL = 1e-4
CLI_T_LOG = 20
# (experiment, net index, n_iter, resume) of the train_cli phase.
CLI_RUNS = [("synth-ac", 4, 40, False), ("synth-ac", 4, 60, True),
            ("synth-sr", 7, 20, False), ("synth-cr", 4, 20, False),
            ("synth-ac-tree", 4, 10, False)]
DESC_TOL = 1e-4  # kernel vs mcm_ref net_desc, per scalar stat
N_SERVE = 20  # batches per timed serving window
N_WINDOWS = 5  # timed serving windows per capacity
N_TRAIN_WINDOWS = 2  # timed windows of N_TRAIN_STEPS single-net steps
N_NETS = 8  # nets of the flagship sweep (experiments.k_cpts)
# Timed windows of N_TRAIN_STEPS sweep steps.
N_SWEEP_WINDOWS = 2
# (experiment, n_iter, resume) of the train_cli phase's --vmap-sweep runs,
# and the synth-ac member whose final descriptor is held against mcm_ref.
SWEEP_CLI_RUNS = [("synth-ac", 40, False), ("synth-ac", 60, True),
                  ("synth-ac-tree", 10, False)]
SWEEP_DESC_NET = 4
MARGIN_TIE = 1e-3  # router top-2 logit margin below which exits may differ
MARGIN_BF16 = 1e-2  # the margin reported for bf16 kernel vs plain exits
# fused_mcm launches per forward of the flagship chain (the eight stages'
# scales) and of the 47-stage tree (fans 1x4 + 2x4 + 4x3, 8 tails x 9).
PER_FORWARD = {"chain": 20, "tree": 96}
# The same under ops.config.stacked_tails: (launches, of which net-axis)
# per forward of one net. The tree's eight tails are one group whose five
# stages (L = 3, 2, 2, 1, 1) take 9 net-axis launches beside the fans' 24
# (a chain's groups are leaves only: its 20 stay 20). Under the sweep every
# launch is on the net axis (8 nets x 8 tails = 64 for the tails).
STACKED_PER_FORWARD = {"tree": (33, 9)}
# Tail stages of the tree (experiments.arch[3:]) on the net axis, in the
# widths and types the stacked paths run them: 8 tails of one tree (fp32
# and bf16 training), 8 trees x 8 tails of the sweep (fp32).
TAIL_FIRST_STAGE = 3
TAIL_NETS = {8: ("fp32", "bf16"), 64: ("fp32",)}
# Timed windows x steps of the training phases, per architecture: the tree's
# host-bound step is ~5x the chain's. The windows are as short as the
# script's time limit needs, on a host slower than the one that measured it.
TRAIN_WINDOWS = {"chain": (N_TRAIN_WINDOWS, N_TRAIN_STEPS), "tree": (2, 3)}
SWEEP_WINDOWS = {"chain": (N_SWEEP_WINDOWS, N_TRAIN_STEPS), "tree": (2, 1)}
# Steps traced by torch.profiler after the windows. Reading a trace back
# (`train_bench.step_split`) took 5-17 s a profiled tree step and ~1.7 s a
# chain step on the card, so the tree phases trace one step each, and only
# in fp32 (PROFILED_PRECISIONS); the chain traces two in both precisions.
PROFILE_STEPS = {"chain": 2, "tree": 1}
PROFILED_PRECISIONS = {"chain": ("fp32", "bf16"), "tree": ("fp32",)}
# bf16 training against fp32 (one step, gradients over the whole tree):
# the kernel path's distance may be at most this multiple of mcm_ref's.
BF16_VS_FP32_FACTOR = 2.0


def phase(name, ok=True, **fields):
    print(json.dumps({"phase": name, "ok": ok,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(outs, refs):
    """max |out - ref| over max |ref|, over lists of tensors."""
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(outs, refs))
    return err / max(float(r.float().abs().max()) for r in refs)


def f64_errs(out, xs, whs, wvs, bs):
    """(max abs error, max|ref|) of the fp32 outputs `out` and of fp32
    mcm_ref on the same inputs, against mcm_ref in float64: ((err, plain
    err), scale). Call with the fp32 compute policy."""
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    ref = mcm_ref([x.double() for x in xs], [w.double() for w in whs],
                  [w.double() for w in wvs], [b.double() for b in bs])
    plain = mcm_ref(xs, whs, wvs, bs)

    def err(outs):
        return max(float((o.double() - r).abs().max())
                   for o, r in zip(outs, ref))
    return (err(out), err(plain)), max(float(r.abs().max()) for r in ref)


def check_f64(label, out, xs, whs, wvs, bs):
    """The fp32 kernel's outputs within F64_TOL of float64 mcm_ref; returns
    the kernel's and fp32 mcm_ref's errors over max|ref|."""
    (err, plain), scale = f64_errs(out, xs, whs, wvs, bs)
    check(err <= F64_TOL * scale, "%s fp32: max abs err %g against float64 "
          "> %g * max|ref| %g" % (label, err, F64_TOL, scale))
    return {"rel_err_vs_f64": err / scale,
            "plain_rel_err_vs_f64": plain / scale}


def grad_phase(device):
    """fused_mcm's gradient on the card against autograd through mcm_ref,
    fp32, one four-scale stage."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import stage_inputs
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref

    xs, whs, wvs, bs, _ = stage_inputs(arch, GRAD_BATCH, 32, seed=3,
                                       device=device)[1]
    leaves = [t.requires_grad_() for t in xs + whs + wvs + bs]
    n0 = fused_mcm.launches
    out = fused_mcm(xs, whs, wvs, bs, 3)
    check(fused_mcm.launches - n0 == len(whs),
          "grad: the kernel did not take the forward")
    check(all(o.grad_fn is not None for o in out),
          "grad: fused_mcm's outputs carry no grad_fn")
    rng = np.random.RandomState(4)
    cot = [torch.as_tensor(rng.standard_normal(tuple(o.shape))
                           .astype(np.float32), device=device) for o in out]
    grads = torch.autograd.grad(out, leaves, cot)
    ref = torch.autograd.grad(mcm_ref(xs, whs, wvs, bs), leaves, cot)
    errs = [rel_err([g], [r]) for g, r in zip(grads, ref)]
    check(max(errs) <= TOL["fp32"], "grad: max relative error %g > %g"
          % (max(errs), TOL["fp32"]))
    return {"stage": 1, "batch": GRAD_BATCH, "n_grads": len(leaves),
            "max_rel_err": max(errs)}


def kernel_phase(device):
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import (bound, stage_cost, stage_inputs,
                                             stage_times, time_ms)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import _forward, fused_mcm, mcm_ref

    def compare(label, xin, whs, wvs, bs, dt):
        out = fused_mcm(xin, whs, wvs, bs, 3)
        ref = mcm_ref(xin, whs, wvs, bs)
        torch.cuda.synchronize()
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(out, ref))
        scale = max(float(r.float().abs().max()) for r in ref)
        check(all(o.dtype == DTYPES[dt] and o.shape == r.shape
                  for o, r in zip(out, ref)),
              "%s %s: output dtype/shape differs" % (label, dt))
        check(err <= TOL[dt] * scale, "%s %s: max abs err %g > %g * "
              "max|ref| %g" % (label, dt, err, TOL[dt], scale))
        return out, err, scale

    def fp32_ref_err(out, xin, whs, wvs, bs):
        """The bf16 kernel against mcm_ref in fp32 on the same bf16-valued
        inputs and weights: the error of bf16 serving itself."""
        config.set_compute_dtype(None)
        try:
            ref = mcm_ref([x.float() for x in xin],
                          [w.to(torch.bfloat16).float() for w in whs],
                          [w.to(torch.bfloat16).float() for w in wvs], bs)
        finally:
            config.set_compute_dtype(torch.bfloat16)
        return rel_err(out, ref)

    # Shapes off the flagship's path, checked only: small ragged widths
    # (6, 3) with an odd batch, so blocks run past the last pixel; output
    # widths that are not a multiple of the kernels' 8-wide mma tiles (12,
    # 20) or wider than one 128-channel block (160); input channel counts
    # read one value at a time (3) or as 16-byte vectors (4, 8, 24).
    odd = [("ragged 12/6/3 stage", [[8, 8, 8]], 7, 12, 8),
           ("c_out 12, c_in 4", [[12, 12]], 5, 8, 4),
           ("c_out 160, c_in 24", [[160, 160]], 3, 8, 24),
           ("c_out 20, c_in 3, 6/3", [[20, 20]], 9, 6, 3)]
    odd = [(label, stage_inputs(a, b, hw, seed=2 + i, device=device,
                                c_in=c)[0])
           for i, (label, a, b, hw, c) in enumerate(odd)]
    stages = list(enumerate(stage_inputs(arch, BATCH, 32, seed=1,
                                         device=device)))
    train = list(enumerate(stage_inputs(arch, TRAIN_BATCH, 32, seed=1,
                                        device=device)))
    deep = list(enumerate(stage_inputs(arch, ROUTED_BATCH, 32, seed=1,
                                       device=device)))[4:]
    runs = ([(dt, BATCH, i, st) for dt in DTYPES for i, st in stages]
            + [(dt, TRAIN_BATCH, i, st) for dt in DTYPES for i, st in train]
            + [("bf16", ROUTED_BATCH, i, st) for i, st in deep])
    rows, off_path = [], []
    for dt, torch_dt in DTYPES.items():
        config.set_compute_dtype(torch_dt)
        try:
            for label, (xs, whs, wvs, bs, _) in odd:
                xin = [x.to(torch_dt) for x in xs]
                out, err, scale = compare(label, xin, whs, wvs, bs, dt)
                rec = {"shape": label, "dtype": dt,
                       "max_abs_err": err, "max_abs_ref": scale}
                if dt == "fp32":
                    rec.update(check_f64(label, out, xin, whs, wvs, bs))
                off_path.append(rec)
            for _, B, i, (xs, whs, wvs, bs, n_ops) in [
                    r for r in runs if r[0] == dt]:
                xin = [x.to(torch_dt) for x in xs]
                out, err, scale = compare("stage %d batch %d" % (i, B), xin,
                                          whs, wvs, bs, dt)
                n_bytes, flops = stage_cost(xin, whs, wvs, bs, n_ops, B, dt)
                row = {"stage": i, "dtype": dt, "batch": B,
                       "shape": [list(x.shape[1:]) for x in xs],
                       "c_out": [int(w.shape[-1]) for w in whs],
                       "max_abs_err": err, "max_abs_ref": scale,
                       "bytes": n_bytes, "flops": flops}
                if dt == "bf16":
                    row["rel_err_vs_fp32_ref"] = fp32_ref_err(out, xin, whs,
                                                              wvs, bs)
                elif B != BATCH:  # float64 kept off batch 1024
                    row.update(check_f64("stage %d batch %d" % (i, B), out,
                                         xin, whs, wvs, bs))
                # Timed on weights already in the compute dtype, so the
                # times hold compute only (the casts are then no-ops).
                row.update(stage_times(xin, whs, wvs, bs))
                # The launches alone, without the autograd Function and the
                # mcm_stage operator's dispatch: ms - launch_ms is what
                # those add to a call.
                wc, vc = ([w.to(torch_dt) for w in ws] for ws in (whs, wvs))
                row["launch_ms"] = time_ms(lambda: _forward(
                    xin[len(xin) - len(wc):], wc, vc, bs, 3, torch_dt))
                row["bound_ms"], row["bound_by"] = bound(n_bytes, flops, dt)
                row["vs_cudnn"] = (row["device_ms"]
                                   / row["cudnn_conv_sequence_device_ms"])
                row["vs_bound"] = row["device_ms"] / row["bound_ms"]
                rows.append(row)
        finally:
            config.set_compute_dtype(None)
    for dt, B in (("fp32", BATCH), ("bf16", BATCH), ("fp32", TRAIN_BATCH),
                  ("bf16", TRAIN_BATCH), ("bf16", ROUTED_BATCH)):
        sel = [r for r in rows if r["dtype"] == dt and r["batch"] == B]
        totals = dict(stage_totals(sel), **{k: sum(r[k] for r in sel)
                                            for k in ("ms", "launch_ms")})
        phase("kernel", dtype=dt, batch=B, totals=totals, stages=[
            {k: r[k] for k in ("stage", "shape", "c_out", "max_abs_err",
                               "rel_err_vs_fp32_ref", "rel_err_vs_f64",
                               "plain_rel_err_vs_f64", "ms", "launch_ms",
                               "plain_ms",
                               "cudnn_conv_sequence_ms", "device_ms",
                               "plain_device_ms",
                               "cudnn_conv_sequence_device_ms", "bound_ms",
                               "bound_by", "vs_cudnn", "vs_bound") if k in r}
            for r in sel])
    phase("kernel_off_path", shapes=off_path)
    return rows


def stage_totals(rows, library="cudnn_conv_sequence_"):
    """The stages' summed device times (kernel, mcm_ref, the library call),
    their bound, and the kernel's ratios to the library and the bound."""
    from mpnn_tpu_torch.kernel_bench import bound
    dt = rows[0]["dtype"]
    t = {k: sum(r[k] for r in rows)
         for k in ("device_ms", "plain_device_ms", library + "device_ms")}
    t["bound_ms"], t["bound_by"] = bound(sum(r["bytes"] for r in rows),
                                         sum(r["flops"] for r in rows), dt)
    t["vs_library"] = t["device_ms"] / t[library + "device_ms"]
    t["vs_bound"] = t["device_ms"] / t["bound_ms"]
    return t


def kernel_nets_phase(device):
    """fused_mcm's net axis: the flagship's eight stages for N_NETS nets at
    the training batch, fp32 and bf16, stage 0's input shared, through
    torch.func.vmap of fused_mcm (one launch per output scale for every
    net), against mcm_ref on each net's slice; in fp32 each net's outputs
    must equal a single-net launch on its tensors bit for bit."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import sweep_stage_inputs
    stages = sweep_stage_inputs(arch, N_NETS, TRAIN_BATCH, 32, seed=1,
                                device=device)
    rows = net_axis_rows("kernel_nets", stages, N_NETS, DTYPES)
    for dt in DTYPES:
        sel = [r for r in rows if r["dtype"] == dt]
        phase("kernel_nets", dtype=dt, nets=N_NETS, batch=TRAIN_BATCH,
              totals=stage_totals(sel, "library_"),
              stages=[{k: v for k, v in r.items()
                       if k not in ("dtype", "nets", "batch", "bytes",
                                    "flops", "max_abs_ref")}
                      for r in sel])
    return rows


def kernel_tails_phase(device):
    """The tree's tail stages (experiments.arch[3:]) on the net axis, every
    input batched, at the training batch: 8 tails of one tree (the
    stacked tails' launches; fp32 and bf16) and 64 (8 trees x 8 tails,
    the sweep with stacked tails; fp32), held and timed as kernel_nets
    holds and times the flagship stages."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import sweep_stage_inputs
    rows = []
    for n, dtypes in TAIL_NETS.items():
        stages = sweep_stage_inputs(arch, n, TRAIN_BATCH, 32, seed=1,
                                    device=device, first=TAIL_FIRST_STAGE)
        rows += net_axis_rows("kernel_tails", stages, n, dtypes,
                              TAIL_FIRST_STAGE)
        del stages
    for n, dtypes in TAIL_NETS.items():
        for dt in dtypes:
            sel = [r for r in rows if r["dtype"] == dt and r["nets"] == n]
            phase("kernel_tails", dtype=dt, nets=n, batch=TRAIN_BATCH,
                  totals=stage_totals(sel, "library_"),
                  stages=[{k: v for k, v in r.items()
                           if k not in ("dtype", "nets", "batch", "bytes",
                                        "flops", "max_abs_ref")}
                          for r in sel])
    return rows


def tail_summary(rows, n_nets, dt):
    """kernel_tails' stages of one width and dtype, summed: call and
    device times of the kernel, mcm_ref net after net and mcm_ref under
    vmap (grouped cuDNN), the bound, the largest error."""
    sel = [r for r in rows if r["nets"] == n_nets and r["dtype"] == dt]
    return dict(nets=n_nets, dtype=dt, batch=TRAIN_BATCH,
                stages=[r["stage"] for r in sel],
                max_abs_err=max(r["max_abs_err"] for r in sel),
                **{k: sum(r[k] for r in sel)
                   for k in ("ms", "plain_ms", "library_ms")},
                **stage_totals(sel, "library_"))


def net_axis_rows(label, stages, n_nets, dtypes, first=0, timed=True):
    """Per dtype and stage of `stages` (kernel_bench.sweep_stage_inputs,
    the first one stage `first`): the stage for n_nets nets through
    torch.func.vmap of fused_mcm, one net-axis launch per output scale,
    held against mcm_ref on each net's slice at the kernel phase's
    tolerances (in fp32 also against float64, and bit for bit against a
    single-net launch per net), timed (kernel_bench.stage_times of
    sweep_stage_fns; not with timed=False) beside the bound of the n_nets
    nets' work."""
    from mpnn_tpu_torch.kernel_bench import (bound, stage_cost, stage_times,
                                             sweep_stage_fns)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref
    rows = []
    for dt in dtypes:
        torch_dt = DTYPES[dt]
        config.set_compute_dtype(torch_dt)
        try:
            for i, (xs, whs, wvs, bs, n_ops) in enumerate(stages, first):
                xin = [x.to(torch_dt) for x in xs]
                shared = xin[0].dim() == 4
                n0, m0 = fused_mcm.launches, fused_mcm.net_launches
                out = sweep_stage_fns(xin, whs, wvs, bs)[""]()
                torch.cuda.synchronize()
                check(fused_mcm.launches - n0 == fused_mcm.net_launches - m0
                      == len(whs), "%s stage %d %s x%d: %d launches, "
                      "expected one net-axis launch per scale (%d)"
                      % (label, i, dt, n_nets, fused_mcm.launches - n0,
                         len(whs)))
                err = scale = single_err = 0.0
                err64 = plain64 = scale64 = 0.0
                bit_equal = True
                for n in range(n_nets):
                    xi = xin if shared else [x[n] for x in xin]
                    args = (xi, [w[n] for w in whs], [w[n] for w in wvs],
                            [b[n] for b in bs])
                    ref = mcm_ref(*args)
                    check(all(o.dtype == DTYPES[dt] and o[n].shape == r.shape
                              for o, r in zip(out, ref)),
                          "%s stage %d %s: output dtype/shape differs"
                          % (label, i, dt))
                    err = max([err] + [float((o[n].float() - r.float())
                                             .abs().max())
                                       for o, r in zip(out, ref)])
                    scale = max([scale] + [float(r.float().abs().max())
                                           for r in ref])
                    single = fused_mcm(*args, 3)
                    bit_equal &= all(torch.equal(o[n], s_)
                                     for o, s_ in zip(out, single))
                    single_err = max([single_err] + [
                        float((s_.float() - r.float()).abs().max())
                        for s_, r in zip(single, ref)])
                    if dt == "fp32":
                        (e64, p64), s64 = f64_errs([o[n] for o in out],
                                                   *args)
                        err64, plain64 = max(err64, e64), max(plain64, p64)
                        scale64 = max(scale64, s64)
                check(err <= TOL[dt] * scale, "%s stage %d %s x%d: max abs "
                      "err %g > %g * max|ref| %g"
                      % (label, i, dt, n_nets, err, TOL[dt], scale))
                check(bit_equal or dt != "fp32", "%s stage %d fp32 x%d: a "
                      "net's outputs differ from its single-net launch"
                      % (label, i, n_nets))
                check(err64 <= F64_TOL * scale64, "%s stage %d fp32 x%d: "
                      "max abs err %g against float64 > %g * max|ref| %g"
                      % (label, i, n_nets, err64, F64_TOL, scale64))
                n_bytes, flops = stage_cost(xin, whs, wvs, bs, n_ops,
                                            TRAIN_BATCH, dt, n_nets)
                row = {"stage": i, "dtype": dt, "nets": n_nets,
                       "batch": TRAIN_BATCH, "input_shared": shared,
                       "c_out": [int(w.shape[-1]) for w in whs],
                       "max_abs_err": err, "max_abs_ref": scale,
                       "single_net_max_abs_err": single_err,
                       "bit_equal_to_single_net": bit_equal,
                       "bytes": n_bytes, "flops": flops}
                if dt == "fp32":
                    row["rel_err_vs_f64"] = err64 / scale64
                    row["plain_rel_err_vs_f64"] = plain64 / scale64
                row["bound_ms"], row["bound_by"] = bound(n_bytes, flops, dt)
                if timed:
                    row.update(stage_times(xin, whs, wvs, bs,
                                           sweep_stage_fns))
                    row["vs_library"] = (row["device_ms"]
                                         / row["library_device_ms"])
                    row["vs_bound"] = row["device_ms"] / row["bound_ms"]
                rows.append(row)
        finally:
            config.set_compute_dtype(None)
    return rows


def serve(net, params, state, x0, cap, reference=False, k_cpt=None):
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    from mpnn_tpu_torch.ops import kernels
    infer = make_routed_infer_fn(net, x0.shape[0], capacities=cap)
    if not reference:
        out = infer(params, state, x0, k_cpt)
    else:
        with mock.patch.object(kernels, "fused_mcm", _plain_stage):
            out = infer(params, state, x0, k_cpt)
    return {k: v.cpu().numpy() for k, v in out.items()}


def tree_paths(net):
    """For each leaf (preorder), the preorder indices of the switches on
    its path from the root."""
    pos = {id(sw): i for i, sw in enumerate(net.switches)}
    paths = []

    def walk(node, path):
        if not node.sinks:
            paths.append(path)
            return
        if len(node.sinks) > 1:
            path = path + [pos[id(node)]]
        for snk in node.sinks:
            walk(snk, path)

    walk(net.root, [])
    return paths


def router_margins(net, params, state, xs, k_cpt):
    """Top-2 router logit margin at every switch, per example, from a dense
    eval pass over the batches xs at price k_cpt: (rows, n_switches)."""
    from mpnn_tpu_torch.models.net import Ctx
    out = []
    for x0 in xs:
        ctx = Ctx(train=False, k_cpt=torch.tensor(k_cpt, device=x0.device))
        with torch.inference_mode():
            recs, _ = net.forward(params, state, x0, None, ctx)
            top2 = [torch.topk(recs[sw].router_x, 2, dim=1).values
                    for sw in net.switches]
            out.append(torch.stack([m[:, 0] - m[:, 1] for m in top2], 1)
                       .cpu().numpy())
    return np.concatenate(out)


def serve_split(net, params, state, xs, cap, k_cpt, reference=False):
    """Routed inference over the batches `xs`, outputs concatenated (the
    forced counts summed)."""
    outs = [serve(net, params, state, x, cap, reference, k_cpt) for x in xs]
    cat = {k: np.concatenate([o[k] for o in outs])
           for k in ("probs", "exit_idx", "ops")}
    cat["forced"] = sum(o["forced"] for o in outs)
    return cat


def compare_fp32(label, net, params, state, xs, n, cap, k_cpt, margins):
    """The kernel path against the mcm_ref path, both on the GPU in fp32,
    over the first n rows of the batches xs: probs within 1e-4 where the
    exits agree, and the same exits, ops and forced counts outside router
    near-ties (a top-2 margin below MARGIN_TIE at any switch on the
    example's path)."""
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    launches0 = fused_mcm.launches
    k = serve_split(net, params, state, xs, cap, k_cpt)
    check(fused_mcm.launches > launches0,
          "%s: kernel path did not launch" % label)
    r = serve_split(net, params, state, xs, cap, k_cpt, reference=True)
    paths = tree_paths(net)
    near_tie = np.array([(margins[e, paths[r["exit_idx"][e]]]
                          < MARGIN_TIE).any() for e in range(n)])
    same_exit = k["exit_idx"][:n] == r["exit_idx"][:n]
    prob_err = float(np.abs(k["probs"][:n] - r["probs"][:n])[same_exit]
                     .max())
    mismatch = ~(same_exit & (k["ops"][:n] == r["ops"][:n]))
    check(not (mismatch & ~near_tie).any(),
          "%s: exit_idx/ops differ on %d examples with router margin >= %g"
          % (label, int((mismatch & ~near_tie).sum()), MARGIN_TIE))
    check(prob_err <= 1e-4, "%s: probs differ by %g > 1e-4"
          % (label, prob_err))
    forced_diff = int(np.abs(k["forced"] - r["forced"]).sum())
    check(forced_diff <= int(near_tie.sum()),
          "%s: forced differs by %d" % (label, forced_diff))
    return k, {"capacity": cap, "max_prob_err": prob_err,
               "near_tie_examples": int(near_tie.sum()),
               "exit_mismatches": int(mismatch.sum()),
               "forced": k["forced"].tolist(),
               "forced_ref": r["forced"].tolist(),
               "mean_ops": float(k["ops"][:n].mean()),
               "exit_hist": np.bincount(k["exit_idx"][:n], minlength=len(
                   list(net.leaves))).tolist()}


def serve_phase(device):
    from mpnn_tpu_torch.data import synth
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.serdes import read_net

    B = BATCH
    net, params, state, _ = read_net(CHECKPOINT, device)
    h, w, c = net.hypers.x0_shape
    data = synth.make_synthetic(n_tr=B, n_ts=B, h=h, w=w, c=c,
                                n_cls=int(net.hypers.y_shape[0]), seed=0)
    x0 = torch.as_tensor(data["x0_ts"], device=device)
    x_cal = torch.as_tensor(data["x0_tr"], device=device)

    config.set_compute_dtype(None)
    caps = calibrate_capacities(net, params, state, x_cal)
    k_cpt = net.hypers.k_cpt
    margins = router_margins(net, params, state, [x0], k_cpt)
    fp32 = [compare_fp32("fp32 capacity %s" % cap, net, params, state, [x0],
                         B, cap, k_cpt, margins)[1]
            for cap in (1.0, caps)]
    phase("serve_fp32_vs_plain", checkpoint=os.path.relpath(CHECKPOINT, HERE),
          batch=B, calibrated_capacities=caps, results=fp32)

    config.set_compute_dtype(torch.bfloat16)
    try:
        drift = bf16_drift(net, params, state, x0)
        caps_bf16 = calibrate_capacities(net, params, state, x_cal)
        modes = [(mode, cap, make_routed_infer_fn(net, B, capacities=cap))
                 for mode, cap in (("dense", 1.0), ("routed", caps_bf16))]
        records = []
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last served batch.
        fused_mcm.launches = 0
        for mode, cap, infer in modes:
            n0 = fused_mcm.launches
            out = infer(params, state, x0)  # warm-up
            torch.cuda.synchronize()
            per_batch = fused_mcm.launches - n0
            rates = []
            for _ in range(N_WINDOWS):
                t = time.perf_counter()
                for _ in range(N_SERVE):
                    out = infer(params, state, x0)
                torch.cuda.synchronize()
                rates.append(N_SERVE * B / (time.perf_counter() - t))
            check(fused_mcm.launches - n0
                  == per_batch * (1 + N_WINDOWS * N_SERVE),
                  "bf16 %s: kernel launches per batch vary" % mode)
            probs = out["probs"].float().cpu().numpy()
            ops = out["ops"].cpu().numpy()
            exit_idx = out["exit_idx"].cpu().numpy()
            check(probs.shape == (B, net.hypers.y_shape[0])
                  and np.isfinite(probs).all()
                  and np.allclose(probs.sum(axis=1), 1.0, atol=1e-3),
                  "bf16 %s: probs are not finite distributions" % mode)
            check(((exit_idx >= 0) & (exit_idx < len(list(net.leaves)))).all()
                  and (ops > 0).all(), "bf16 %s: bad exits/ops" % mode)
            forced = out["forced"].cpu().numpy()
            records.append({
                "metric": "routed-inference (%s, capacity=%s)" % (
                    mode, "calibrated" if isinstance(cap, list) else cap),
                "value": statistics.median(rates),
                "unit": "images/sec/chip",
                "window_values": rates,
                "window_batches": N_SERVE,
                "mean_ops_per_example": float(ops.mean()),
                "forced_exits": int(forced.sum()),
                "forced_per_switch": forced.tolist(),
                "kernel_launches_per_batch": per_batch,
            })
        launches = fused_mcm.launches
    finally:
        config.set_compute_dtype(None)
    return caps_bf16, records, launches, drift


def bf16_drift(net, params, state, x0):
    """bf16 dense serving through the kernel against the same through
    mcm_ref: the exits that differ, and how many of those have a deciding
    router (any switch up to the first where the two paths part) whose
    top-2 margin on the kernel path is below MARGIN_BF16. Printed, not a
    gate: the two paths round at different places."""
    margins = router_margins(net, params, state, [x0], net.hypers.k_cpt)
    k = serve(net, params, state, x0, 1.0)
    r = serve(net, params, state, x0, 1.0, reference=True)
    paths = tree_paths(net)
    # The switches both paths visit: up to the one where they part.
    near_tie = np.array([
        (margins[e, sorted(set(paths[a]) & set(paths[b]))] < MARGIN_BF16)
        .any() for e, (a, b) in enumerate(zip(k["exit_idx"],
                                              r["exit_idx"]))])
    differ = k["exit_idx"] != r["exit_idx"]
    same = ~differ
    return {"capacity": 1.0, "examples": int(len(differ)),
            "exit_mismatches": int(differ.sum()),
            "exit_mismatches_margin_below": MARGIN_BF16,
            "exit_mismatches_near_tie": int((differ & near_tie).sum()),
            "near_tie_examples": int(near_tie.sum()),
            "max_prob_err_same_exit": float(np.abs(
                k["probs"].astype(np.float32)
                - r["probs"].astype(np.float32))[same].max())
            if same.any() else None}


TREE_DIR = os.path.join(HERE, "results", "nets", "hybrid-ac-tree-dynkcpt")
# The trained adaptive tree in its committed compact form (bfloat16
# weights, 16 MB). The 40 MB fp32 net.npy beside it is listed in
# .gitignore, to keep a checkout small, so a checkout that leaves out
# ignored files lacks it; where it is present, tree_desc_phase also
# evaluates it, to measure what the rounding of the weights changes.
TREE_CHECKPOINT = os.path.join(TREE_DIR, "net.npy.cz")
TREE_FP32 = os.path.join(TREE_DIR, "net.npy")
N_TREE_PASSES = 1  # passes over the test split per timed serving window
N_TREE_WINDOWS = 2  # timed serving windows per capacity and k_cpt
EVAL_BATCH = 1024  # the batch of the trained tree's full-split evaluation
# The k_cpts (indices) of tree_desc_vs_jax_files, the ends of the price
# range: one evaluation of both splits takes ~8 s on the card.
TREE_DESC_K = (0, 7)


def tree_serve_phase(device):
    """Routed serving of the trained 47-stage adaptive tree on the test
    split of the rebuilt hybrid.npz, at every k_cpt, dense and at
    capacities calibrated on the train split: fp32 through the kernel
    against mcm_ref (compare_fp32), then bf16 (the main path, the
    kernel's count from 0) timed, with its exits against fp32's."""
    from mpnn_tpu_torch.data.prep import synthetic_archive
    from mpnn_tpu_torch.experiments import k_cpts
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.serdes import read_net

    t = time.perf_counter()
    net, params, state, extra = read_net(TREE_CHECKPOINT, device)
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    data = synthetic_archive("hybrid.npz")
    prep_s = time.perf_counter() - t
    check(len(list(net.layers)) == 95 and len(list(net.switches)) == 39,
          "tree_serve: the checkpoint is not the 47-stage tree")
    B, n = BATCH, len(data["x0_ts"])
    n_pad = -(-n // B) * B
    x_ts = np.resize(data["x0_ts"], (n_pad,) + data["x0_ts"].shape[1:])
    xs = [torch.as_tensor(x_ts[i:i + B], device=device)
          for i in range(0, n_pad, B)]
    x_cal = torch.as_tensor(data["x0_tr"][:B], device=device)
    y_ts = np.argmax(data["y_ts"], axis=1)
    config.set_compute_dtype(None)
    per_k, fp32_out = [], {}
    for k_cpt in k_cpts:
        margins = router_margins(net, params, state, xs, k_cpt)
        caps = calibrate_capacities(net, params, state, x_cal, k_cpt=k_cpt)
        rec = {"k_cpt": k_cpt, "calibrated_capacities": caps}
        for mode, cap in (("dense", 1.0), ("routed", caps)):
            out, rec[mode] = compare_fp32(
                "tree_serve k_cpt %g %s" % (k_cpt, mode), net, params, state,
                xs, n, cap, k_cpt, margins)
            rec[mode]["accuracy"] = float(np.mean(
                np.argmax(out["probs"][:n], axis=1) == y_ts))
            fp32_out[k_cpt, mode] = out["exit_idx"][:n]
        per_k.append(rec)

    config.set_compute_dtype(torch.bfloat16)
    try:
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last served batch.
        fused_mcm.launches = 0
        for rec in per_k:
            k_cpt, infers = rec["k_cpt"], {}
            for mode, cap in (("dense", 1.0),
                              ("routed", rec["calibrated_capacities"])):
                infer = make_routed_infer_fn(net, B, capacities=cap)
                outs = [infer(params, state, x, k_cpt) for x in xs]
                exits = torch.cat([o["exit_idx"] for o in outs])[:n]
                ops = torch.cat([o["ops"] for o in outs])[:n].cpu().numpy()
                probs = torch.cat([o["probs"] for o in outs])[:n].float()
                check(bool(torch.isfinite(probs).all()) and (ops > 0).all(),
                      "tree_serve bf16 k_cpt %g %s: bad probs or ops"
                      % (k_cpt, mode))
                n0 = fused_mcm.launches
                infer(params, state, xs[0], k_cpt)
                torch.cuda.synchronize()
                per_batch = fused_mcm.launches - n0
                infers[mode] = infer
                rec[mode]["bf16"] = {
                    "mean_ops": float(ops.mean()),
                    "forced": int(sum(o["forced"].sum() for o in outs)),
                    "exit_mismatches_vs_fp32": int(
                        (exits.cpu().numpy() != fp32_out[k_cpt, mode])
                        .sum()),
                    "launches_per_batch": per_batch,
                    "accuracy": float(np.mean(
                        probs.argmax(1).cpu().numpy() == y_ts))}
            # Timed windows of whole passes over the (padded) test split,
            # dense and routed in turns, so both modes meet the same host.
            rates = {mode: [] for mode in infers}
            for _ in range(N_TREE_WINDOWS):
                for mode, infer in infers.items():
                    t = time.perf_counter()
                    for _ in range(N_TREE_PASSES):
                        for x in xs:
                            infer(params, state, x, k_cpt)
                    torch.cuda.synchronize()
                    rates[mode].append(N_TREE_PASSES * n_pad
                                       / (time.perf_counter() - t))
            for mode, r in rates.items():
                rec[mode]["bf16"].update(img_s=statistics.median(r),
                                         window_values=r)
        launches = fused_mcm.launches
    finally:
        config.set_compute_dtype(None)
    check(launches > 0, "tree_serve: fused_mcm was not launched")
    return {"checkpoint": os.path.relpath(TREE_CHECKPOINT, HERE),
            "checkpoint_t": extra["t"], "read_s": read_s,
            "dataset": "hybrid.npz rebuilt (50,000 / 2,000)",
            "prep_s": prep_s, "batch": B, "test_examples": n,
            "window_batches": N_TREE_PASSES * len(xs),
            "windows": N_TREE_WINDOWS,
            "per_k_cpt": per_k, "fused_mcm_launches": launches}, (
        net, params, state, extra["t"], data)


def tree_desc_phase(device, tree):
    """net_desc of the trained tree at the k_cpts of TREE_DESC_K (indices
    into experiments.k_cpts) through the kernel, fp32,
    on the rebuilt hybrid.npz, at the τ of its last training step, beside
    the committed descriptor files of its training: accuracy, moc and the
    largest difference of any scalar stat (printed, not gated). Where the
    fp32 net.npy is present (TREE_FP32), it is evaluated the same way and
    set beside both, which separates the compact archive's rounding from
    the rest."""
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.experiments import k_cpts, τ_ds
    from mpnn_tpu_torch.models.steps import make_eval_split_fn
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import read_net
    net, params, state, n_iter, data = tree
    config.set_compute_dtype(None)
    ds = Dataset(data, device=device)
    eval_split = make_eval_split_fn(net, EVAL_BATCH)
    fp32 = (read_net(TREE_FP32, device)[1:3] if os.path.exists(TREE_FP32)
            else None)

    def desc_at(k_cpt, p, s):
        return net_desc(net, ds, p, s, batch_size=EVAL_BATCH,
                        tau=τ_ds(n_iter - 1), k_cpt=k_cpt,
                        eval_split=eval_split)

    def beside(ours, theirs):
        """The largest difference of a scalar stat and where it is, or
        (None, None) if the schemas differ."""
        ours, theirs = _scalar_stats(ours), _scalar_stats(theirs)
        if [p for p, _ in ours] != [p for p, _ in theirs]:
            return None, None
        return max((abs(a - b), p) for (p, a), (_, b) in zip(ours, theirs))

    rows = []
    t = time.perf_counter()
    for i in TREE_DESC_K:
        k_cpt = k_cpts[i]
        desc = desc_at(k_cpt, params, state)
        jax_desc = np.load(os.path.join(TREE_DIR, "%.4i-stats.npy" % i),
                           allow_pickle=True)[()]
        diff, at = beside(desc, jax_desc)
        row = {"k_cpt": k_cpt, "same_schema": diff is not None,
               "acc_ts": desc["stats_ts"]["acc"],
               "acc_ts_files": jax_desc["stats_ts"]["acc"],
               "acc_tr": desc["stats_tr"]["acc"],
               "acc_tr_files": jax_desc["stats_tr"]["acc"],
               "moc_ts": desc["stats_ts"]["moc"],
               "moc_ts_files": jax_desc["stats_ts"]["moc"],
               "max_abs_stat_diff": diff, "at": at}
        if fp32 is not None:
            full = desc_at(k_cpt, *fp32)
            row["fp32_weights"] = {
                "acc_ts": full["stats_ts"]["acc"],
                "acc_tr": full["stats_tr"]["acc"],
                "moc_ts": full["stats_ts"]["moc"],
                "vs_compact": beside(desc, full),
                "vs_files": beside(full, jax_desc)}
        rows.append(row)
    return {"eval_batch": EVAL_BATCH, "tau": τ_ds(n_iter - 1),
            "seconds": time.perf_counter() - t,
            "weights": "bfloat16-rounded (the compact archive)",
            "fp32_weights": (os.path.relpath(TREE_FP32, HERE)
                             if fp32 is not None else "absent"),
            "max_acc_ts_diff": max(abs(r["acc_ts"] - r["acc_ts_files"])
                                   for r in rows), "per_k_cpt": rows}


def _leaves(tree, path=()):
    """[(path, tensor)] of a params-shaped tree."""
    if isinstance(tree, dict):
        return [e for k, v in tree.items() for e in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [e for i, v in enumerate(tree) for e in _leaves(v, path + (i,))]
    return [(path, tree)]


def zero_grad_paths(net):
    """Paths of the biases right before a train-mode BatchNorm: a dense
    layer's bias, and a MultiscaleConvMax's last-scale bias (its coarser
    scales' biases also reach the next scale through a zero-padded vertical
    conv). BN subtracts the batch mean, so their exact gradient is zero."""
    from mpnn_tpu_torch.ops import layers as L
    out = set()

    def chain(layer, path):
        nxt = layer.comps[1:] + [None]
        for i, (c, n) in enumerate(zip(layer.comps, nxt)):
            if isinstance(n, (L.BatchNorm, L.MultiscaleBatchNorm)):
                if isinstance(c, L.LinTrans):
                    out.add(path + ("comps", i, "b"))
                elif isinstance(c, L.MultiscaleConvMax):
                    out.add(path + ("comps", i, "b_%d" % (c._L - 1)))

    def node(n, path):
        chain(n, path + ("layer",))
        if n.router is not None:
            chain(n.router, path + ("router",))
        for i, snk in enumerate(n.sinks):
            node(snk, path + ("sinks", i))

    node(net.root, ())
    return out


def tree_errs(tree, ref, zero_paths=frozenset()):
    """Errors of `tree` against `ref` over the leaves outside zero_paths:
    ||tree - ref|| / ||ref|| of the whole tree, and per leaf the largest
    such ratio, its path and how many leaves exceed DISCRETE_TOL; over
    the leaves in zero_paths, the largest max(||tree||, ||ref||) / ||ref
    tree||."""
    a, b = _leaves(tree), _leaves(ref)
    check([p for p, _ in a] == [p for p, _ in b], "trees differ in shape")
    total = float(torch.sqrt(sum(torch.sum(r.double() ** 2) for _, r in b)))
    num = den = 0.0
    worst, worst_path, n_over, zero = 0.0, None, 0, 0.0
    for (path, t), (_, r) in zip(a, b):
        t, r = t.double(), r.double()
        if path in zero_paths:
            zero = max(zero, max(float(t.norm()), float(r.norm())) / total)
            continue
        d, n = float((t - r).norm()), float(r.norm())
        num, den = num + d * d, den + n * n
        # A structurally zero gradient (an unused scale, a router behind
        # a zero-initialized layer) must be zero on both paths.
        e = d / n if n else (0.0 if d == 0 else float("inf"))
        n_over += e > DISCRETE_TOL
        if e > worst:
            worst, worst_path = e, path
    return {"tree": (num / den) ** 0.5, "leaf": worst,
            "worst_leaf": "/".join(map(str, worst_path or ())),
            "leaves_over_%g" % DISCRETE_TOL: n_over, "zero_grad": zero}


def _plain_stage(xs, whs, wvs, bs, supp):
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    return mcm_ref(xs, whs, wvs, bs)


def _float64_stage(xs, whs, wvs, bs, supp):
    """mcm_ref in float64, rounded to fp32 at the stage's outputs: another,
    more exact implementation of the stage."""
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    outs = mcm_ref(*([t.double() for t in ts] for ts in (xs, whs, wvs, bs)))
    return [o.float() for o in outs]


def train_once(net, params, state, vel, data, stage=None, mesh=None):
    """One training step of the flagship from the generator seed 0, through
    the kernel, or through `stage` patched in for fused_mcm: the loss,
    gradients and launches of `loss_and_grads`, then the whole step's
    params, state and launches. With a mesh, this rank's step of its data
    axis: the loss and gradients after the step's all-reduce, the global
    batch's."""
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, _all_reduce_step,
                                             _step_pieces, make_train_step)
    from mpnn_tpu_torch.ops import kernels
    from mpnn_tpu_torch.utils.tree import tree_map
    counter = kernels.fused_mcm
    sched = Schedules(lr=λ_lrn, tau=τ_ds)
    batch_ctx, loss_and_grads = _step_pieces(net, TRAIN_BATCH, sched, 4,
                                             False, mesh)
    step = make_train_step(net, TRAIN_BATCH, sched, mesh=mesh)
    params, vel = (tree_map(torch.clone, t) for t in (params, vel))
    # Under stacked_tails, packed as the training loop carries them.
    (params, state, vel), unpack = _packing(net, (params, state, vel))
    with mock.patch.object(kernels, "fused_mcm", stage or counter):
        n0, m0 = counter.launches, counter.net_launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        xb, yb, ctx = batch_ctx(0, gen, *data, None)
        loss, _, p_tr, grads = loss_and_grads(params, state, xb, yb, ctx)
        loss, _, grads = _all_reduce_step(ctx.data, loss, p_tr, grads)
        n1, m1 = counter.launches, counter.net_launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        params, state, vel, _ = step(params, state, vel, 0, gen, *data)
        torch.cuda.synchronize()
        n2, m2 = counter.launches, counter.net_launches
    return {"loss": float(loss), "grads": unpack(grads),
            "params": unpack(params), "state": unpack(state),
            "launches": (n1 - n0, n2 - n1),
            "net_launches": (m1 - m0, m2 - m1)}


def train_vs_plain_phase(device, arch="chain"):
    """One fp32 step through the kernel against the same through mcm_ref,
    of the flagship actor chain or (arch="tree") the actor tree."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device, arch=arch)
    data = train_bench.train_data(net, device)
    k = train_once(net, params, state, vel, data)
    r = train_once(net, params, state, vel, data, _plain_stage)
    f64 = train_once(net, params, state, vel, data, _float64_stage)
    per_fwd = mcm_launches_per_forward(net)
    check(per_fwd == PER_FORWARD[arch] and k["launches"] == (per_fwd, per_fwd)
          and r["launches"] == (0, 0),
          "train %s: kernel launches per forward %s, expected %d (plain "
          "path %s)" % (arch, k["launches"], PER_FORWARD[arch],
                        r["launches"]))
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("train", k, r, zero)
    # Not a gate: the same comparison for a float64 stage, which rounds
    # differently from the plain path without being wrong.
    baseline = {"loss_rel_err": abs(f64["loss"] - r["loss"]) / abs(r["loss"]),
                "gradient": tree_errs(f64["grads"], r["grads"], zero),
                "parameter": tree_errs(f64["params"], r["params"], zero)}
    return {"arch": arch, "batch": TRAIN_BATCH, "loss": k["loss"],
            "loss_plain": r["loss"],
            "loss_rel_err": loss_err, "errors": errs, "tolerances": TRAIN_TOL,
            "float64_stage_vs_plain": baseline,
            "n_leaves": len(_leaves(k["grads"])),
            "launches_per_forward": per_fwd}


def step_gates(label, k, r, zero):
    """One step `k` held against the same step `r` (train_once records):
    the loss within TRAIN_TOL["loss"], the BatchNorm statistics per leaf,
    the gradients and parameters over the tree, per leaf and at the
    zero-gradient biases. Returns (loss error, errors)."""
    loss_err = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    errs = {"gradient": tree_errs(k["grads"], r["grads"], zero),
            "parameter": tree_errs(k["params"], r["params"], zero),
            "BatchNorm statistic": tree_errs(k["state"], r["state"])}
    check(loss_err <= TRAIN_TOL["loss"], "%s: loss %g vs %g"
          % (label, k["loss"], r["loss"]))
    check(errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "%s: BatchNorm statistic error %g > %g"
          % (label, errs["BatchNorm statistic"]["leaf"], TRAIN_TOL["state"]))
    for name in ("gradient", "parameter"):
        for key in ("tree", "leaf", "zero_grad"):
            check(errs[name][key] <= TRAIN_TOL[key], "%s: %s %s error "
                  "%g > %g (worst leaf %s)" % (label, name, key,
                                               errs[name][key],
                                               TRAIN_TOL[key],
                                               errs[name]["worst_leaf"]))
    return loss_err, errs


def tree_stacked_vs_serial_phase(device):
    """One fp32 step of the fresh actor tree at the training batch with
    stacked tails (packed, as the loop carries them) through the kernel,
    against the serial step through the kernel and against the stacked
    step through mcm_ref, at train_fp32_vs_plain's gates; 33 launches per
    stacked forward, 9 of them on the net axis."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device, arch="tree")
    data = train_bench.train_data(net, device)
    serial = train_once(net, params, state, vel, data)
    config.set_stacked_tails(True)
    try:
        k = train_once(net, params, state, vel, data)
        r = train_once(net, params, state, vel, data, _plain_stage)
        per_fwd = (mcm_launches_per_forward(net),
                   mcm_launches_per_forward(net, net_axis_only=True))
    finally:
        config.set_stacked_tails(False)
    n, m = STACKED_PER_FORWARD["tree"]
    check(per_fwd == (n, m) and k["launches"] == (n, n)
          and k["net_launches"] == (m, m) and r["launches"] == (0, 0)
          and serial["launches"] == (PER_FORWARD["tree"],) * 2
          and serial["net_launches"] == (0, 0),
          "tree stacked: launches per forward %s (net axis %s), expected "
          "%d (%d); plain %s; serial %s" % (
              k["launches"], k["net_launches"], n, m, r["launches"],
              serial["launches"]))
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("tree stacked vs serial", k, serial, zero)
    plain_err, plain_errs = step_gates("tree stacked kernel vs plain", k, r,
                                       zero)
    return {"arch": "tree", "batch": TRAIN_BATCH, "loss": k["loss"],
            "loss_serial": serial["loss"], "loss_plain": r["loss"],
            "loss_rel_err": loss_err, "errors": errs,
            "vs_plain": {"loss_rel_err": plain_err, "errors": plain_errs},
            "tolerances": TRAIN_TOL, "groups": [
                [len(g["members"]), len(g["preorders"][0])]
                for g in net._stack_plan],
            "launches_per_forward": n, "net_launches_per_forward": m}


def train_phase(device, precision, arch="chain", stacked=False):
    """The training main path in one precision, of the flagship actor chain
    or (arch="tree") the actor tree: a warm-up step and timed windows
    (TRAIN_WINDOWS), the kernel's count from 0; then, in
    PROFILED_PRECISIONS, PROFILE_STEPS steps under torch.profiler for the
    device's time, operations and idle share per step. With stacked, under stacked_tails, the trees packed once
    before the warm-up as the training loop carries them."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_step
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    n_windows, n_window_steps = TRAIN_WINDOWS[arch]
    config.set_compute_dtype(DTYPES[precision])
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel = train_bench.build(0, device, arch=arch)
        data = train_bench.train_data(net, device)
        extra = {}
        if precision == "bf16":
            r = train_once(net, params, state, vel, data, _plain_stage)
            extra["bf16_first_loss_plain"] = r["loss"]
        (params, state, vel), _ = _packing(net, (params, state, vel))
        step = make_train_step(net, TRAIN_BATCH,
                               Schedules(lr=λ_lrn, tau=τ_ds))
        gen = torch.Generator(device=device).manual_seed(0)
        per_fwd = (mcm_launches_per_forward(net),
                   mcm_launches_per_forward(net, net_axis_only=True))
        # The main path: the kernel's counts start from 0 here and are
        # read just after the last step.
        fused_mcm.launches = fused_mcm.net_launches = 0
        params, state, vel, c = step(params, state, vel, 0, gen, *data)
        loss_first, t = float(c), 0
        rates, losses = [], []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_window_steps):
                t += 1
                params, state, vel, c = step(params, state, vel, t, gen,
                                             *data)
            torch.cuda.synchronize()
            rates.append(n_window_steps * TRAIN_BATCH
                         / (time.perf_counter() - t0))
            losses.append(float(c))
        launches, net_launches = fused_mcm.launches, fused_mcm.net_launches

        def more(params, state, vel, t):
            for _ in range(PROFILE_STEPS[arch]):
                t += 1
                params, state, vel, _ = step(params, state, vel, t, gen,
                                             *data)
        profile = (profile_steps(more, (params, state, vel, t),
                                 PROFILE_STEPS[arch])
                   if precision in PROFILED_PRECISIONS[arch] else None)
    finally:
        config.set_compute_dtype(None)
        config.set_stacked_tails(False)
    check(all(np.isfinite(losses)) and np.isfinite(loss_first),
          "train %s %s: loss not finite: %s" % (arch, precision, losses))
    n_steps = 1 + n_windows * n_window_steps
    expect = (STACKED_PER_FORWARD[arch] if stacked
              else (PER_FORWARD[arch], 0))
    check(per_fwd == expect and (launches, net_launches) == (
        expect[0] * n_steps, expect[1] * n_steps),
          "train %s %s%s: %d launches (%d of the net axis) in %d steps, "
          "expected %s a step" % (arch, precision,
                                  " stacked" if stacked else "", launches,
                                  net_launches, n_steps, expect))
    if precision == "bf16":
        extra["bf16_first_loss_kernel"] = loss_first
    if stacked:
        extra.update(stacked_tails=True, fused_mcm_net_launches=net_launches)
    label = ("" if arch == "chain" else "tree, ") + (
        "stacked tails, " if stacked else "")
    return {"arch": arch, "batch": TRAIN_BATCH,
            "metric": "train-step (%s%s, batch %d)"
            % (label, precision, TRAIN_BATCH),
            "value": statistics.median(rates),
            "unit": "images/sec", "window_values": rates,
            "window_steps": n_window_steps, "loss_first": loss_first,
            "loss_window_ends": losses, "fused_mcm_launches": launches,
            "steps": n_steps, "profile": profile, **extra}


def profile_steps(run, args, n_steps):
    """`run(*args)` (n_steps steps) under torch.profiler: the device time
    per step, its operations per step and its idle share
    (train_bench.step_split), without the list of operations."""
    import gc
    from mpnn_tpu_torch.train_bench import step_split
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    # Reading the trace back builds one object an event; the collector's
    # passes over the heap meanwhile cost ~a quarter of it.
    gc.disable()
    try:
        split = step_split(prof, n_steps)
    finally:
        gc.enable()
    split.pop("top_device_ops")
    return dict(split, steps=n_steps,
                profiled_ms_per_step=host_s * 1e3 / n_steps)


def sweep_once(net, trees, k_cpts, data, stage=None):
    """One step of the flagship sweep, its batch sampled from the generator
    seed 0 and augmented from seed 1, through the kernel's net axis or
    through `stage` patched in for fused_mcm: the members' losses,
    gradients and launches of the vmapped loss and gradient, then the
    whole step's params, state, velocity and launches."""
    from mpnn_tpu_torch.data.augment import augment_presampled, sampled_batch
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, _sweep_members,
                                             _sweep_step_body)
    from mpnn_tpu_torch.ops import kernels
    from mpnn_tpu_torch.utils.tree import tree_map
    counter = kernels.fused_mcm
    loss_and_grads, _ = _sweep_members(net, TRAIN_BATCH)
    step = _sweep_step_body(net, TRAIN_BATCH, Schedules(lr=λ_lrn, tau=τ_ds))
    params, state, vel = trees
    params, vel = (tree_map(torch.clone, t) for t in (params, vel))
    # Under stacked_tails, packed after the nets' axis as the loop does.
    (params, state, vel), unpack = _packing(net, (params, state, vel), 1)
    x0, y, m_sym = data
    dev = x0.device
    with mock.patch.object(kernels, "fused_mcm", stage or counter):
        xb, yb = sampled_batch(torch.Generator(dev).manual_seed(0), x0, y,
                               TRAIN_BATCH)
        n0, m0 = counter.launches, counter.net_launches
        xa, ya = augment_presampled(torch.Generator(dev).manual_seed(1), xb,
                                    yb, m_sym)
        grads, (loss, _) = loss_and_grads(params, state, k_cpts, xa, ya,
                                          τ_ds(0))
        n1, m1 = counter.launches, counter.net_launches
        params, state, vel, _ = step(params, state, vel, 0,
                                     torch.Generator(dev).manual_seed(1), xb,
                                     yb, m_sym, k_cpts)
        torch.cuda.synchronize()
        n2, m2 = counter.launches, counter.net_launches
    return {"loss": loss.tolist(), "grads": unpack(grads),
            "params": unpack(params), "state": unpack(state),
            "vel": unpack(vel), "launches": (n1 - n0, n2 - n1),
            "net_launches": (m1 - m0, m2 - m1)}


def sweep_vs_plain_phase(device, arch="chain", stacked=False):
    """One fp32 step of the 8-net sweep of flagship actor chains (or trees)
    through the kernel's net axis against the same step through mcm_ref,
    at the gates of train_fp32_vs_plain over the sweep's stacked trees
    (the losses per member); the worst member's errors and, for the chain,
    the same comparison for a float64 stage are printed beside them. With
    stacked, under stacked_tails (each tree's tails a vmap inside the
    sweep's, every launch on the net axis)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.tree import unstack_tree
    config.set_compute_dtype(None)
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel, k_cpts = train_bench.build_sweep(
            N_NETS, 0, device, arch)
        data = train_bench.train_data(net, device)
        k = sweep_once(net, (params, state, vel), k_cpts, data)
        r = sweep_once(net, (params, state, vel), k_cpts, data, _plain_stage)
        f64 = (sweep_once(net, (params, state, vel), k_cpts, data,
                          _float64_stage) if arch == "chain" else None)
        per_fwd = mcm_launches_per_forward(net)
    finally:
        config.set_stacked_tails(False)
    expect = (STACKED_PER_FORWARD if stacked else PER_FORWARD)[arch]
    expect = expect[0] if stacked else expect
    check(per_fwd == expect and k["launches"] == (per_fwd, per_fwd)
          and k["net_launches"] == k["launches"]
          and r["launches"] == (0, 0),
          "sweep %s%s: kernel launches per sweep forward %s (net axis %s), "
          "expected %d (plain path %s)" % (
              arch, " stacked" if stacked else "", k["launches"],
              k["net_launches"], expect, r["launches"]))
    zero = zero_grad_paths(net)
    names = {"gradient": "grads", "parameter": "params",
             "BatchNorm statistic": "state"}

    def errs(a, b, i=None):
        pick = (lambda t: t) if i is None else (lambda t: unstack_tree(t, i))
        return {name: tree_errs(pick(a[key]), pick(b[key]),
                                frozenset() if key == "state" else zero)
                for name, key in names.items()}

    def worst_member(a, b):
        worst = {}
        for i in range(N_NETS):
            for name, e in errs(a, b, i).items():
                if e["tree"] >= worst.get(name, {}).get("tree", -1.0):
                    worst[name] = dict(e, net=i)
        return worst

    loss_errs = [abs(a - b) / abs(b) for a, b in zip(k["loss"], r["loss"])]
    all_errs = errs(k, r)
    check(max(loss_errs) <= TRAIN_TOL["loss"], "sweep: losses %s vs %s"
          % (k["loss"], r["loss"]))
    check(all_errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "sweep: BatchNorm statistic error %g > %g"
          % (all_errs["BatchNorm statistic"]["leaf"], TRAIN_TOL["state"]))
    for name in ("gradient", "parameter"):
        for key in ("tree", "leaf", "zero_grad"):
            check(all_errs[name][key] <= TRAIN_TOL[key], "sweep: %s %s "
                  "error %g > %g (worst leaf %s)" % (
                      name, key, all_errs[name][key], TRAIN_TOL[key],
                      all_errs[name]["worst_leaf"]))
    # Not gates: the member the flips move most, and the same comparisons
    # for a float64 stage, which rounds differently without being wrong.
    out = {"arch": arch, "nets": N_NETS, "batch": TRAIN_BATCH,
           "k_cpts": k_cpts.tolist(), "loss": k["loss"],
           "loss_plain": r["loss"], "loss_rel_err": max(loss_errs),
           "errors": all_errs, "tolerances": TRAIN_TOL,
           "worst_member": worst_member(k, r),
           "launches_per_sweep_forward": per_fwd, "stacked_tails": stacked}
    if f64 is not None:
        out["float64_stage_vs_plain"] = {"errors": errs(f64, r),
                                         "worst_member": worst_member(f64, r)}
    return out


def sweep_train_phase(device, precision, single, arch="chain",
                      stacked=False):
    """The sweep's training main path in one precision: N_NETS flagship
    chains (or trees) trained at once by make_sweep_train_loop, a warm-up
    step, then timed windows (SWEEP_WINDOWS) of one call each, the
    kernel's counts from 0; `single` is the same call's single-net
    record of train_phase. With stacked, under stacked_tails (the loop
    packs each call's trees)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_sweep_train_loop
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    n_windows, n_window_steps = SWEEP_WINDOWS[arch]
    config.set_compute_dtype(DTYPES[precision])
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel, k_cpts = train_bench.build_sweep(
            N_NETS, 0, device, arch)
        per_fwd = mcm_launches_per_forward(net)
        data = train_bench.train_data(net, device)
        loop = make_sweep_train_loop(net, TRAIN_BATCH,
                                     Schedules(lr=λ_lrn, tau=τ_ds))
        # The main path: the kernel's counts start from 0 here and are read
        # just after the last step.
        fused_mcm.launches = fused_mcm.net_launches = 0
        params, state, vel, cs = loop(params, state, vel, 0, 0, *data, 1,
                                      k_cpts)
        loss_first, t = cs[-1].tolist(), 1
        rates, losses = [], []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, vel, cs = loop(params, state, vel, t, 0, *data,
                                          n_window_steps, k_cpts)
            t += n_window_steps
            torch.cuda.synchronize()
            rates.append(N_NETS * n_window_steps * TRAIN_BATCH
                         / (time.perf_counter() - t0))
            losses.append(cs[-1].tolist())
        launches, net_launches = fused_mcm.launches, fused_mcm.net_launches
        profile = None
        if arch == "tree" and precision in PROFILED_PRECISIONS[arch]:
            n = PROFILE_STEPS[arch]
            profile = profile_steps(
                lambda *a: loop(*a, 0, *data, n, k_cpts),
                (params, state, vel, t), n)
    finally:
        config.set_compute_dtype(None)
        config.set_stacked_tails(False)
    check(all(np.isfinite(v).all() for v in losses + [loss_first]),
          "sweep %s %s: loss not finite: %s" % (arch, precision, losses))
    n_steps = 1 + n_windows * n_window_steps
    expect = (STACKED_PER_FORWARD[arch][0] if stacked
              else PER_FORWARD[arch])
    check(per_fwd == expect
          and launches == net_launches == per_fwd * n_steps,
          "sweep %s %s%s: %d launches (%d of the net axis) in %d steps, "
          "expected %d a step" % (arch, precision,
                                  " stacked" if stacked else "", launches,
                                  net_launches, n_steps, expect))
    value = statistics.median(rates)
    label = ("" if arch == "chain" else "tree, ") + (
        "stacked tails, " if stacked else "")
    return {"arch": arch, "nets": N_NETS, "batch_per_net": TRAIN_BATCH,
            "metric": "train-sweep (%s%s, %d nets x batch %d)"
            % (label, precision, N_NETS, TRAIN_BATCH), "value": value,
            "unit": "images/sec (all nets)", "window_values": rates,
            "window_steps": n_window_steps, "profile": profile,
            "single_net_value": single["value"],
            "single_net_window_values": single["window_values"],
            "vs_single_net": value / single["value"],
            "loss_first": loss_first, "loss_window_ends": losses,
            "fused_mcm_launches": launches,
            "fused_mcm_net_launches": net_launches, "steps": n_steps,
            "stacked_tails": stacked}


def bf16_vs_fp32(run, zero):
    """The C1 gate of bf16 training: `run(stage)` (one step of the same
    params and batch, through the kernel for stage None or through
    mcm_ref) in bf16 and in fp32; the kernel path's bf16 gradients may be
    at most BF16_VS_FP32_FACTOR times as far from its fp32 gradients, over
    the whole tree, as mcm_ref's bf16 gradients are from mcm_ref's fp32
    ones. The worst leaf's distances are printed beside them."""
    from mpnn_tpu_torch.ops import config
    grads = {}
    for dt in ("bf16", "fp32"):
        config.set_compute_dtype(DTYPES[dt] if dt == "bf16" else None)
        try:
            for name, stage in (("kernel", None), ("plain", _plain_stage)):
                grads[name, dt] = run(stage)["grads"]
        finally:
            config.set_compute_dtype(None)
    dist = {name: tree_errs(grads[name, "bf16"], grads[name, "fp32"], zero)
            for name in ("kernel", "plain")}
    check(dist["kernel"]["tree"]
          <= BF16_VS_FP32_FACTOR * dist["plain"]["tree"],
          "bf16 vs fp32: the kernel path's gradient distance %g > %g x "
          "mcm_ref's %g" % (dist["kernel"]["tree"], BF16_VS_FP32_FACTOR,
                            dist["plain"]["tree"]))
    return {"kernel_bf16_vs_kernel_fp32": dist["kernel"],
            "plain_bf16_vs_plain_fp32": dist["plain"],
            "tree_ratio": dist["kernel"]["tree"] / dist["plain"]["tree"],
            "leaf_ratio": dist["kernel"]["leaf"] / dist["plain"]["leaf"],
            "gate": "tree distance ratio <= %g" % BF16_VS_FP32_FACTOR}


def train_bf16_vs_fp32_phase(device):
    """One step of the fresh flagship chain at the training batch, four
    ways from the same params and batch (kernel and mcm_ref, bf16 and
    fp32), held to the bf16_vs_fp32 gate."""
    from mpnn_tpu_torch import train_bench
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    return dict(batch=TRAIN_BATCH, **bf16_vs_fp32(
        lambda stage: train_once(net, params, state, vel, data, stage),
        zero_grad_paths(net)))


def sweep_bf16_vs_fp32(device):
    """bf16_vs_fp32 of one step of the 8-net flagship sweep (the stacked
    gradients of all members)."""
    from mpnn_tpu_torch import train_bench
    net, params, state, vel, k_cpts = train_bench.build_sweep(N_NETS, 0,
                                                              device)
    data = train_bench.train_data(net, device)
    return bf16_vs_fp32(
        lambda stage: sweep_once(net, (params, state, vel), k_cpts, data,
                                 stage), zero_grad_paths(net))


def mcm_launches_per_forward(net, net_axis_only=False):
    """fused_mcm launches of one forward of `net`: one per output scale of
    every MultiscaleConvMax that takes the kernel; under stacked_tails a
    stack-plan group's template counts once (one net-axis launch for all
    its members). With net_axis_only, the groups' launches alone."""
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax

    def launches(nodes):
        return sum(c._L for node in nodes for c in node.comps
                   if isinstance(c, MultiscaleConvMax)
                   and c._kernel_eligible())

    plan = net._stack_plan if config.stacked_tails else []
    grouped = {id(n) for g in plan for pre in g["preorders"] for n in pre}
    net_axis = sum(launches(g["preorders"][0]) for g in plan)
    if net_axis_only:
        return net_axis
    return net_axis + launches(n for n in net.layers
                               if id(n) not in grouped)


def _packing(net, trees, axis=0):
    """`trees` in the packed layout the loops carry when stacked_tails is
    on (and the net has a plan), else as they are; with the function that
    brings a tree back to the node layout."""
    from mpnn_tpu_torch.ops import config
    if not (config.stacked_tails and net._stack_plan):
        return trees, lambda t: t
    return ([net.pack_tree(t, axis) for t in trees],
            lambda t: net.unpack_tree(t, axis))


def _scalar_stats(desc, path=""):
    """[(path, value)] of every scalar stat of a descriptor."""
    out = [(path + "/" + k, v) for key in ("stats_tr", "stats_ts")
           for k, v in sorted(desc.get(key, {}).items())
           if isinstance(v, float)]
    for i, s in enumerate(desc.get("sinks", [desc["root"]] if "root" in desc
                                   else [])):
        out += _scalar_stats(s, "%s/%d" % (path, i))
    return out


def train_cli_phase(device):
    """The training CLI's path (`_train_cli_runs`) with deterministic
    algorithms, as the CLI's `set_up_device` sets them, the warnings of
    ops without a deterministic form collected; the default mode after."""
    import warnings
    from mpnn_tpu_torch import set_deterministic
    set_deterministic(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec = _train_cli_runs(device)
    finally:
        set_deterministic(False)
    rec["nondeterministic_ops"] = sorted({
        str(w.message)[:200] for w in caught
        if "determinis" in str(w.message)})
    return rec


def _train_cli_runs(device):
    """The training CLI's path: runs of train_experiment in a temporary
    directory, their launches counted from 0."""
    import contextlib
    import io
    import tempfile
    from mpnn_tpu_torch import train as cli
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.data.prep import make_synthetic_archives
    from mpnn_tpu_torch.experiments import make_experiments, τ_ds
    from mpnn_tpu_torch.ops import config, kernels
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import read_net
    from mpnn_tpu_torch.utils.tree import tree_map, unstack_tree

    config.set_compute_dtype(None)
    registry = make_experiments()
    live = []
    original, original_sweep = cli.train_one_net, cli._train_sweep

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
        live.append(out)
        return out

    def keep_sweep(*args, **kwargs):
        out = original_sweep(*args, **kwargs)
        live.append(out)
        return out

    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        make_synthetic_archives(os.path.join(d, "data"), small=True)
        prep_s = time.perf_counter() - t
        out_root = os.path.join(d, "nets")
        rows = []
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last run.
        fused_mcm.launches = 0
        for expt, i, n_iter, resume in CLI_RUNS:
            n0, timings, buf = fused_mcm.launches, [], io.StringIO()
            t = time.perf_counter()
            with mock.patch.object(cli, "train_one_net", keep), \
                    contextlib.redirect_stdout(buf):
                cli.train_experiment(
                    expt, n_iter=n_iter, t_log=CLI_T_LOG,
                    batch_size=TRAIN_BATCH, net_indices=[i], data_root=d,
                    out_root=out_root, resume=resume, device=device,
                    timings=timings)
            wall = time.perf_counter() - t
            n = fused_mcm.launches - n0
            # The checkpoint now on disk against the live state (a later
            # resume overwrites it); reading it launches nothing.
            _, params, state, extra = read_net(os.path.join(
                out_root, expt, "%.4i.npy" % i), device)
            same = []
            tree_map(lambda a, b: same.append(torch.equal(a, b)),
                     (params, state, extra["vel"]), live[-1][:3])
            rows.append((expt, i, n_iter, resume, timings[0], wall, n,
                         buf.getvalue(), live[-1][3],
                         bool(same) and all(same), extra["t"]))
        # Gate 0 (C1): synth-ac net 4 from 0 to 60 in one run, traced
        # (--profile-dir) and NaN-checked (--debug-nans), into a root of
        # its own; held below against the run stopped at 40 and resumed.
        prof_root = os.path.join(d, "nets-profiled")
        prof_dir = os.path.join(d, "profile")
        expt, i, n_iter, _ = CLI_RUNS[1]
        n0, timings, buf = fused_mcm.launches, [], io.StringIO()
        t = time.perf_counter()
        config.set_debug_nans(True)
        try:
            with contextlib.redirect_stdout(buf):
                cli.train_experiment(
                    expt, n_iter=n_iter, t_log=CLI_T_LOG,
                    batch_size=TRAIN_BATCH, net_indices=[i], data_root=d,
                    out_root=prof_root, device=device, timings=timings,
                    profile_dir=prof_dir)
        finally:
            config.set_debug_nans(False)
        profiled = {"wall_s": time.perf_counter() - t,
                    "launches": fused_mcm.launches - n0,
                    "timings": timings[0], "text": buf.getvalue()}
        sweep_root = os.path.join(d, "nets-sweep")
        sweep_rows = []
        for expt, n_iter, resume in SWEEP_CLI_RUNS:
            n0, timings, buf = fused_mcm.launches, [], io.StringIO()
            t = time.perf_counter()
            with mock.patch.object(cli, "_train_sweep", keep_sweep), \
                    contextlib.redirect_stdout(buf):
                cli.train_experiment(
                    expt, n_iter=n_iter, t_log=CLI_T_LOG,
                    batch_size=TRAIN_BATCH, data_root=d,
                    out_root=sweep_root, resume=resume, device=device,
                    timings=timings, vmap_sweep=True)
            wall = time.perf_counter() - t
            n = fused_mcm.launches - n0
            same, ckpt_ts = [], []
            for j in range(N_NETS):
                _, params, state, extra = read_net(os.path.join(
                    sweep_root, expt, "%.4i.npy" % j), device)
                tree_map(lambda a, b: same.append(torch.equal(a, b)),
                         (params, state, extra["vel"]),
                         [unstack_tree(tr, j) for tr in live[-1][:3]])
                ckpt_ts.append(extra["t"])
            sweep_rows.append((expt, n_iter, resume, timings[0], wall, n,
                               buf.getvalue(), live[-1][3],
                               bool(same) and all(same), ckpt_ts))
        launches = fused_mcm.launches
        gate0 = _gate0(device, d, out_root, prof_root, prof_dir, profiled)

        records, reached = [], {}
        for (expt, i, n_iter, resume, tm, wall, n, text, desc, same,
             ckpt_t) in rows:
            e = registry[expt]
            ds = Dataset(os.path.join(d, e.dataset), device_put=False)
            net = e.nets[i](ds.x0_shape, ds.y_shape)
            t_start = reached[expt, i] if resume else 0
            reached[expt, i] = n_iter
            evals = (sum(t % CLI_T_LOG == 0
                         for t in range(t_start + 1, n_iter + 1))
                     + (n_iter % CLI_T_LOG != 0))
            eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                               for x in (ds.x0_tr, ds.x0_ts))
            per_fwd = mcm_launches_per_forward(net)
            expect = per_fwd * (n_iter - t_start + evals * eval_batches)
            label = "%s net %d to %d%s" % (expt, i, n_iter,
                                          " (resumed)" if resume else "")
            check(n == expect, "train_cli %s: %d launches, expected %d = %d "
                  "x (%d steps + %d evals x %d batches)" % (
                      label, n, expect, per_fwd, n_iter - t_start, evals,
                      eval_batches))
            check(tm["t_start"] == t_start and tm["evals"] == evals,
                  "train_cli %s: started at %d with %d evals" % (
                      label, tm["t_start"], tm["evals"]))
            if resume:
                check("[resuming %s at t=%d]" % (os.path.join(
                    out_root, expt, "%.4i.npy" % i), t_start) in text,
                      "train_cli %s: no resume at t=%d" % (label, t_start))
            root = os.path.join(out_root, expt)
            names = ["MANIFEST.json", "%.4i-stats.npy" % i,
                     "%.4i-log.txt" % i, "%.4i.npy" % i] + [
                "%.4i-stats/%.8i.npy" % (i, t)
                for t in range(CLI_T_LOG, n_iter + 1, CLI_T_LOG)]
            missing = [x for x in names
                       if not os.path.exists(os.path.join(root, x))]
            check(not missing, "train_cli %s: missing %s" % (label, missing))
            check(same and ckpt_t == n_iter,
                  "train_cli %s: checkpoint differs from the live state "
                  "(t=%s)" % (label, ckpt_t))
            check(all(np.isfinite(v) for _, v in _scalar_stats(desc)),
                  "train_cli %s: stats not finite" % label)
            imgs = tm["steps"] * tm["batch_size"]
            records.append({
                "run": label, "steps": tm["steps"], "evals": tm["evals"],
                "eval_batches": eval_batches, "launches": n,
                "launches_per_forward": per_fwd, "wall_s": wall,
                "train_s": tm["train_s"], "eval_s": tm["eval_s"],
                "write_s": tm["write_s"], "total_s": tm["total_s"],
                "eval_s_per_eval": tm["eval_s"] / tm["evals"],
                "train_img_s": imgs / tm["train_s"],
                "total_img_s": imgs / tm["total_s"],
                "acc_ts": desc["stats_ts"]["acc"]})

        reached, sweep_records = {}, []
        for (expt, n_iter, resume, tm, wall, n, text, descs, same,
             ckpt_ts) in sweep_rows:
            e = registry[expt]
            ds = Dataset(os.path.join(d, e.dataset), device_put=False)
            net = e.nets[0](ds.x0_shape, ds.y_shape)
            per_fwd = mcm_launches_per_forward(net)
            eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                               for x in (ds.x0_tr, ds.x0_ts))
            t_start = reached.get(expt, 0) if resume else 0
            reached[expt] = n_iter
            evals = (sum(t % CLI_T_LOG == 0
                         for t in range(t_start + 1, n_iter + 1))
                     + (n_iter % CLI_T_LOG != 0))
            expect = per_fwd * (n_iter - t_start + evals * eval_batches)
            label = "%s --vmap-sweep to %d%s" % (
                expt, n_iter, " (resumed)" if resume else "")
            check(n == expect, "train_cli %s: %d launches, expected %d = %d "
                  "x (%d steps + %d evals x %d batches)" % (
                      label, n, expect, per_fwd, n_iter - t_start, evals,
                      eval_batches))
            check(tm["t_start"] == t_start and tm["evals"] == evals
                  and tm["n_nets"] == N_NETS, "train_cli %s: started at %d "
                  "with %d evals of %d nets" % (label, tm["t_start"],
                                                tm["evals"], tm["n_nets"]))
            if resume:
                check("[resuming %s sweep at t=%d]" % (expt, t_start) in text,
                      "train_cli %s: no resume at t=%d" % (label, t_start))
            root = os.path.join(sweep_root, expt)
            names = ["MANIFEST.json"] + [
                name % j for j in range(N_NETS)
                for name in ["%.4i-stats.npy", "%.4i-log.txt", "%.4i.npy"]
                + ["%%.4i-stats/%.8i.npy" % t
                   for t in range(CLI_T_LOG, n_iter + 1, CLI_T_LOG)]]
            missing = [x for x in names
                       if not os.path.exists(os.path.join(root, x))]
            check(not missing, "train_cli %s: missing %s" % (label, missing))
            check(same and ckpt_ts == [n_iter] * N_NETS,
                  "train_cli %s: checkpoints differ from the live state "
                  "(t=%s)" % (label, ckpt_ts))
            check(all(np.isfinite(v) for desc in descs
                      for _, v in _scalar_stats(desc)),
                  "train_cli %s: stats not finite" % label)
            imgs = N_NETS * tm["steps"] * tm["batch_size"]
            sweep_records.append({
                "run": label, "nets": N_NETS, "steps": tm["steps"],
                "evals": tm["evals"], "eval_batches": eval_batches,
                "launches": n, "launches_per_sweep_forward": per_fwd,
                "wall_s": wall, "train_s": tm["train_s"],
                "eval_s": tm["eval_s"], "write_s": tm["write_s"],
                "total_s": tm["total_s"],
                "train_img_s_all_nets": imgs / tm["train_s"],
                "total_img_s_all_nets": imgs / tm["total_s"],
                "acc_ts": [desc["stats_ts"]["acc"] for desc in descs]})

        # The sweep's final descriptor of one member, from its vmapped
        # evaluation through the kernel's net axis, against net_desc of the
        # member's checkpoint through mcm_ref.
        net, params, state, _ = read_net(os.path.join(
            sweep_root, "synth-ac", "%.4i.npy" % SWEEP_DESC_NET), device)
        ds = Dataset(os.path.join(d, registry["synth-ac"].dataset),
                     device=device)
        last = [r for r in sweep_rows if r[0] == "synth-ac"][-1]
        with mock.patch.object(kernels, "fused_mcm", _plain_stage):
            plain = net_desc(net, ds, params, state, batch_size=TRAIN_BATCH,
                             tau=τ_ds(last[1] - 1))
        sweep_diffs = [(abs(a - b) / max(1.0, abs(b)), p)
                       for (p, a), (_, b) in zip(
                           _scalar_stats(last[7][SWEEP_DESC_NET]),
                           _scalar_stats(plain))]
        sweep_worst, sweep_worst_path = max(sweep_diffs)
        check(sweep_worst <= DESC_TOL, "train_cli: the sweep's descriptor of "
              "net %d through the kernel and net_desc through mcm_ref differ "
              "by %g at %s" % (SWEEP_DESC_NET, sweep_worst,
                               sweep_worst_path))

        # The final synth-ac checkpoint, evaluated through the kernel and
        # through mcm_ref.
        net, params, state, _ = read_net(
            os.path.join(out_root, "synth-ac", "0004.npy"), device)
        ds = Dataset(os.path.join(d, registry["synth-ac"].dataset),
                     device=device)
        descs = []
        for stage in (None, _plain_stage):
            with mock.patch.object(kernels, "fused_mcm",
                                   stage or kernels.fused_mcm):
                descs.append(net_desc(net, ds, params, state,
                                      batch_size=TRAIN_BATCH,
                                      tau=τ_ds(CLI_RUNS[1][2] - 1)))
        diffs = [(abs(a - b) / max(1.0, abs(b)), p)
                 for (p, a), (_, b) in zip(_scalar_stats(descs[0]),
                                           _scalar_stats(descs[1]))]
        worst, worst_path = max(diffs)
        check(worst <= DESC_TOL, "train_cli: net_desc through the kernel "
              "and through mcm_ref differ by %g at %s" % (worst, worst_path))
    return {"batch": TRAIN_BATCH, "t_log": CLI_T_LOG, "precision": "fp32",
            "prep_s": prep_s, "runs": records, "sweep_runs": sweep_records,
            "fused_mcm_launches": launches, "resume_vs_uninterrupted": gate0,
            "desc_kernel_vs_plain": {"max_err": worst, "at": worst_path,
                                     "n_stats": len(diffs),
                                     "tolerance": DESC_TOL},
            "sweep_desc_kernel_vs_plain": {
                "net": SWEEP_DESC_NET, "max_err": sweep_worst,
                "at": sweep_worst_path, "n_stats": len(sweep_diffs),
                "tolerance": DESC_TOL}}


def _gate0(device, d, out_root, prof_root, prof_dir, profiled):
    """C1's gate on the card: synth-ac net 4 trained from 0 to 60 in one
    run (traced and NaN-checked: `profiled`) against the run stopped at
    40 and resumed to 60 (`out_root`): the same files, the final
    checkpoints' params, state, momentum and step bit for bit, and every
    stats file equal. The trace names the fp32 kernel among its device
    events; the run's launches are per_forward x (steps + evaluations x
    eval batches), its profiled steps included. Then one step of the
    final checkpoint with a NaN forced into a param under debug_nans
    raises FloatingPointError naming the step."""
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.experiments import make_experiments, λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_loop
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.serdes import read_net
    from mpnn_tpu_torch.utils.tree import tree_leaves
    expt, i, n_iter, _ = CLI_RUNS[1]
    got, want = (os.path.join(r, expt) for r in (prof_root, out_root))
    files = [sorted(_files_of(r)) for r in (got, want)]
    check(files[0] == files[1], "train_cli gate 0: the uninterrupted run "
          "wrote %s, the resumed %s" % (files[0], files[1]))
    ckpts = [read_net(os.path.join(r, "%.4i.npy" % i), device)
             for r in (got, want)]
    (_, pa, sa, ea), (_, pb, sb, eb) = ckpts
    la = tree_leaves((pa, sa, ea["vel"]))
    lb = tree_leaves((pb, sb, eb["vel"]))
    differ = sum(not torch.equal(a, b) for a, b in zip(la, lb))
    worst = max(float((a - b).abs().max()) for a, b in zip(la, lb))
    check(ea["t"] == eb["t"] == n_iter and differ == 0,
          "train_cli gate 0: the uninterrupted run to %d and the resumed "
          "one differ in %d of %d leaves (max abs %g; t %s / %s)"
          % (n_iter, differ, len(la), worst, ea["t"], eb["t"]))
    stats = [f for f in files[0] if f.endswith(".npy") and "stats" in f]
    unequal = [f for f in stats
               if np.load(os.path.join(got, f), allow_pickle=True)[()]
               != np.load(os.path.join(want, f), allow_pickle=True)[()]]
    check(not unequal, "train_cli gate 0: stats files differ: %s" % unequal)

    trace = os.path.join(prof_dir, "trace.json")
    check("[profiler trace written to %s]" % trace in profiled["text"],
          "train_cli --profile-dir: no trace line")
    with open(trace, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mcm = [e for e in kernels if "mcm_scale_tf32" in e.get("name", "")]
    # Each step's update is one "optimizer" range on the host (the card's
    # copy of it is a "gpu_user_annotation").
    steps = sum(e.get("name") == "optimizer"
                and e.get("cat") == "user_annotation" for e in events)
    e = make_experiments()[expt]
    ds = Dataset(os.path.join(d, e.dataset), device=device)
    net = e.nets[i](ds.x0_shape, ds.y_shape)
    per_fwd = mcm_launches_per_forward(net)
    eval_batches = sum(-(-len(x) // TRAIN_BATCH) for x in (ds.x0_tr,
                                                            ds.x0_ts))
    tm = profiled["timings"]
    evals = n_iter // CLI_T_LOG
    expect = per_fwd * (n_iter + evals * eval_batches)
    check(mcm and steps == 8, "train_cli --profile-dir: %d mcm_scale_tf32 "
          "kernels and %d steps in the trace" % (len(mcm), steps))
    check(profiled["launches"] == expect and tm["evals"] == evals
          and tm["steps"] == n_iter, "train_cli profiled run: %d launches, "
          "expected %d = %d x (%d steps + %d evals x %d batches)"
          % (profiled["launches"], expect, per_fwd, n_iter, evals,
             eval_batches))

    params, state, vel = pa, sa, ea["vel"]
    tree_leaves(params)[0].view(-1)[0] = float("nan")
    loop = make_train_loop(net, TRAIN_BATCH, Schedules(lr=λ_lrn, tau=τ_ds))
    k_cpt = float(np.float32(net.hypers.k_cpt))
    config.set_debug_nans(True)
    try:
        loop(params, state, vel, n_iter, 5, *ds.train_arrays, 1, k_cpt)
        raised = None
    except FloatingPointError as err:
        raised = str(err)
    finally:
        config.set_debug_nans(False)
    check(raised is not None and ("NaN at step %d in " % n_iter) in raised,
          "debug_nans: a NaN forced into a param raised %r" % raised)
    return {"run": "%s net %d to %d, uninterrupted, --profile-dir and "
                   "--debug-nans" % (expt, i, n_iter),
            "bit_for_bit": True, "leaves": len(la),
            "files": len(files[0]), "stats_files_equal": len(stats),
            "launches": profiled["launches"], "launches_per_forward":
                per_fwd, "steps": n_iter, "evals": evals,
            "eval_batches": eval_batches, "wall_s": profiled["wall_s"],
            "train_s": tm["train_s"], "train_img_s":
                n_iter * TRAIN_BATCH / tm["train_s"],
            "trace_mb": os.path.getsize(trace) / 2 ** 20,
            "trace_steps": steps, "trace_kernels": len(kernels),
            "trace_mcm_scale_tf32": len(mcm),
            "trace_kernel_names": sorted({k["name"][:60] for k in mcm})[:3],
            "forced_nan": raised}


# (experiment, n_iter, t_log, stats_log, resume) of the adaptive_cli phase,
# each one `python -m mpnn_tpu_torch.train_adaptive` process.
ADAPTIVE_RUNS = [("synth-ac-tree-dynkcpt", 5, 5, True, False),
                 ("synth-ac-tree-dynkcpt", 10, 5, True, True),
                 ("synth-cr-dynkcpt", 5, None, False, False)]
# The first run again with --stacked-tails, into an output root of its own.
ADAPTIVE_STACKED_RUN = ("synth-ac-tree-dynkcpt", 5, 5, True, False)
ADAPTIVE_TIMEOUT_S = 600  # a wave of adaptive_cli's runs, start to end
DEFAULT_T_LOG = 2500


def _records_equal(a, b):
    """Two decoded checkpoint records equal, arrays bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_records_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_records_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def _adaptive_jobs(d):
    """[(run spec, stacked, output root)] of adaptive_cli, in check order:
    the serial runs from scratch, the resume, the stacked run. A resume
    continues a copy of its run's output root, so the run's own files
    stay as it left them for the checks."""
    roots = {False: os.path.join(d, "nets"), True: os.path.join(d,
                                                                "nets-stacked")}
    return ([(r, False, os.path.join(d, "nets-resumed") if r[4]
              else roots[False]) for r in ADAPTIVE_RUNS]
            + [(ADAPTIVE_STACKED_RUN, True, roots[True])])


def _adaptive_command(d, spec, stacked, out_root):
    expt, n_iter, t_log, stats_log, resume = spec
    cmd = [sys.executable, "-m", "mpnn_tpu_torch.train_adaptive", expt,
           "--n-iter", str(n_iter), "--batch-size", str(TRAIN_BATCH),
           "--data-root", d, "--out-root", out_root]
    cmd += ["--t-log", str(t_log)] if t_log else []
    cmd += ["--stats-log"] if stats_log else []
    cmd += ["--resume"] if resume else []
    return cmd + (["--stacked-tails"] if stacked else [])


def start_adaptive_cli(d):
    """adaptive_cli's processes, on a thread of their own, in directory d
    (its data written here first): the runs that start from nothing at
    once, then each resume in a copy of its run's output root. Returns
    (thread, done, stop): `done[j]` is job j's (returncode, stdout,
    stderr, wall seconds), or "error" the thread's exception; setting
    `stop` kills what runs and ends the thread. `adaptive_cli_phase`
    checks them after the thread ends."""
    import shutil
    import subprocess
    import threading
    from mpnn_tpu_torch.data.prep import save_archive, synthetic_archive
    save_archive(os.path.join(d, "data", "synth.npz"),
                 synthetic_archive("synth.npz", small=True))
    jobs = _adaptive_jobs(d)
    done, stop = {}, threading.Event()

    def waves():
        for wave in (False, True):
            if any(r[0] for r in done.values()):
                return  # a run failed: adaptive_cli_phase reports it
            started = {}
            for j, (spec, stacked, root) in enumerate(jobs):
                if spec[4] != wave:
                    continue
                if wave:  # the resume continues a copy of its run's root
                    src = next(r for s_, st, r in jobs
                               if not s_[4] and not st and s_[0] == spec[0])
                    shutil.copytree(os.path.join(src, spec[0]),
                                    os.path.join(root, spec[0]))
                logs = [open(os.path.join(d, "run%d.%s" % (j, x)), "w+")
                        for x in ("out", "err")]
                started[j] = (subprocess.Popen(
                    _adaptive_command(d, spec, stacked, root), cwd=HERE,
                    stdout=logs[0], stderr=logs[1], text=True),
                    logs, time.perf_counter())
            t_end = time.perf_counter() + ADAPTIVE_TIMEOUT_S
            try:
                while started:
                    if stop.is_set() or time.perf_counter() > t_end:
                        raise RuntimeError(
                            "adaptive_cli: stopped, or a wave took over "
                            "%d s" % ADAPTIVE_TIMEOUT_S)
                    for j, (proc, logs, t) in list(started.items()):
                        if proc.poll() is None:
                            continue
                        wall = time.perf_counter() - t
                        texts = []
                        for f in logs:
                            f.seek(0)
                            texts.append(f.read())
                            f.close()
                        done[j] = (proc.returncode, *texts, wall)
                        del started[j]
                    time.sleep(0.2)
            finally:
                for proc, logs, _ in started.values():
                    proc.kill()
                    proc.wait()
                    for f in logs:
                        f.close()

    def run():
        try:
            waves()
        except BaseException as e:  # noqa: BLE001 -- re-raised on the check
            done["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, done, stop


def adaptive_cli_phase(device, d, started):
    """The adaptive trainer's CLI, `python -m mpnn_tpu_torch.train_adaptive`,
    as separate processes on the small synthetic archive, fp32, batch 128
    (ADAPTIVE_RUNS, and ADAPTIVE_STACKED_RUN with --stacked-tails into
    another output root: the first run's file set, and its launches with
    33 a forward, 9 on the net axis), started by `start_adaptive_cli` in
    d. The runs that do not resume share the card at once, and with the
    phases beside them, then the resume runs, so their rates are not one
    process's alone. Gates: each exits 0; the files; net.npy read back
    by the port and written again equals the file bit for bit, with t =
    n_iter; the resume starts where the first run ended; each process's
    launches (its last line) equal per_forward x (steps + evaluations x
    eval batches), the
    evaluations one per k_cpt at every stats boundary and at the end; the
    final tree's descriptor files, written through the kernel, equal
    net_desc of its net.npy through mcm_ref within DESC_TOL x max(1,
    |stat|) at every k_cpt."""
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.experiments import (k_cpts,
                                            make_adaptive_experiments)
    from mpnn_tpu_torch.ops import config, kernels
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import encode_net, read_net

    thread, done, _ = started
    thread.join(2 * ADAPTIVE_TIMEOUT_S)
    check(not thread.is_alive(), "adaptive_cli: the runs did not end")
    if "error" in done:
        raise done["error"]
    jobs = _adaptive_jobs(d)
    for j, (rc, _, stderr, _) in done.items():
        check(rc == 0, "adaptive_cli %s: exit %d: %s" % (" ".join(
            _adaptive_command(d, *jobs[j])[3:]), rc, stderr[-2000:]))
    registry = make_adaptive_experiments()
    config.set_compute_dtype(None)
    records, launches, reached = [], 0, {}
    ds = Dataset(os.path.join(d, "data", "synth.npz"), device=device)
    eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                       for x in (ds.x0_tr, ds.x0_ts))
    file_sets, final = {}, {}
    for j, ((expt, n_iter, t_log, stats_log, resume), stacked,
            out_root) in enumerate(jobs):
        cmd = _adaptive_command(d, jobs[j][0], stacked, out_root)
        _, stdout, _, wall = done[j]
        label = " ".join(cmd[3:4] + cmd[4:6] + cmd[12:])
        tm = json.loads(stdout.strip().splitlines()[-1])
        t_start = reached.get(expt, 0) if resume else 0
        reached[expt] = n_iter
        chunk = min(n_iter, t_log or DEFAULT_T_LOG)
        boundaries = [t for t in range(t_start + 1, n_iter)
                      if t % chunk == 0] if stats_log else []
        evals = len(k_cpts) * (len(boundaries) + 1)
        net = registry[expt].net(ds.x0_shape, ds.y_shape)
        config.set_stacked_tails(stacked)
        per_fwd = mcm_launches_per_forward(net)
        per_net = mcm_launches_per_forward(net, net_axis_only=True)
        config.set_stacked_tails(False)
        forwards = n_iter - t_start + evals * eval_batches
        expect = per_fwd * forwards
        check(tm["t_start"] == t_start and tm["evals"] == evals
              and tm["fused_mcm_launches"] == expect
              and tm["fused_mcm_net_launches"] == per_net * forwards
              and tm["stacked_tails"] == stacked,
              "adaptive_cli %s: started at %d with %d evaluations and "
              "%d launches (%d net-axis), expected %d, %d and %d = %d "
              "(%d) x (%d steps + %d x %d batches)" % (
                  label, tm["t_start"], tm["evals"],
                  tm["fused_mcm_launches"], tm["fused_mcm_net_launches"],
                  t_start, evals, expect, per_fwd, per_net,
                  n_iter - t_start, evals, eval_batches))
        root = os.path.join(out_root, expt)
        if not resume and (expt, n_iter) == ADAPTIVE_STACKED_RUN[:2]:
            file_sets[stacked] = sorted(
                os.path.relpath(os.path.join(a, f), root)
                for a, _, fs in os.walk(root) for f in fs)
        final[expt, stacked] = out_root
        ckpt = os.path.join(root, "net.npy")
        if resume:
            check("[resuming %s at t=%d]" % (ckpt, t_start) in stdout,
                  "adaptive_cli %s: no resume at t=%d" % (label, t_start))
        snaps = list(range(chunk, n_iter + 1, chunk)) if stats_log else []
        names = (["MANIFEST.json", "net.npy"]
                 + ["%.4i-stats.npy" % i for i in range(len(k_cpts))]
                 + ["%.4i-stats/%.8i.npy" % (i, t_)
                    for i in range(len(k_cpts)) for t_ in snaps])
        missing = [x for x in names
                   if not os.path.exists(os.path.join(root, x))]
        check(not missing, "adaptive_cli %s: missing %s" % (label, missing))
        raw = np.load(ckpt, allow_pickle=True)[()]
        net_r, params, state, extra = read_net(ckpt, device)
        again = encode_net(net_r, params, state, extra)
        check(_records_equal(again, raw) and extra["t"] == n_iter,
              "adaptive_cli %s: net.npy does not read back bit for bit "
              "(t=%s)" % (label, extra["t"]))
        launches += tm["fused_mcm_launches"]
        imgs = tm["steps"] * tm["batch_size"]
        records.append({
            "run": label, "steps": tm["steps"], "evals": evals,
            "eval_batches": eval_batches,
            "launches": tm["fused_mcm_launches"],
            "net_launches": tm["fused_mcm_net_launches"],
            "launches_per_forward": per_fwd, "wall_s": wall,
            "train_s": tm["train_s"], "eval_s": tm["eval_s"],
            "write_s": tm["write_s"], "total_s": tm["total_s"],
            "eval_s_per_eval": tm["eval_s"] / evals,
            "train_img_s": imgs / tm["train_s"],
            "total_img_s": imgs / tm["total_s"]})

    check(file_sets[True] == file_sets[False], "adaptive_cli: "
          "--stacked-tails wrote %s, the serial run %s"
          % (file_sets[True], file_sets[False]))

    def desc_vs_plain(root, expt):
        """The tree's final descriptor files (written through the
        kernel) against net_desc of its net.npy through mcm_ref,
        serially: the largest difference and where."""
        tau_fn = registry[expt].tau
        net, params, state, extra = read_net(
            os.path.join(root, expt, "net.npy"), device)
        worst, worst_at = 0.0, None
        with mock.patch.object(kernels, "fused_mcm", _plain_stage):
            for i, k_cpt in enumerate(k_cpts):
                plain = net_desc(net, ds, params, state,
                                 batch_size=TRAIN_BATCH,
                                 tau=tau_fn(extra["t"] - 1), k_cpt=k_cpt)
                written = np.load(os.path.join(root, expt,
                                               "%.4i-stats.npy" % i),
                                  allow_pickle=True)[()]
                a, b = _scalar_stats(written), _scalar_stats(plain)
                check([p for p, _ in a] == [p for p, _ in b],
                      "adaptive_cli: descriptor schemas differ")
                for (p, x), (_, y) in zip(a, b):
                    e = abs(x - y) / max(1.0, abs(y))
                    if e >= worst:
                        worst, worst_at = e, "k_cpt %d %s" % (i, p)
        check(worst <= DESC_TOL, "adaptive_cli %s: the descriptor files "
              "and net_desc through mcm_ref differ by %g at %s"
              % (root, worst, worst_at))
        return {"max_err": worst, "at": worst_at, "tolerance": DESC_TOL}

    # The trees as the last run of each left them: the resumed serial tree,
    # the stacked one.
    desc = desc_vs_plain(final[ADAPTIVE_RUNS[1][0], False],
                         ADAPTIVE_RUNS[1][0])
    desc_stacked = desc_vs_plain(final[ADAPTIVE_STACKED_RUN[0], True],
                                 ADAPTIVE_STACKED_RUN[0])
    return {"batch": TRAIN_BATCH, "precision": "fp32", "runs": records,
            "fused_mcm_launches": launches, "desc_kernel_vs_plain": desc,
            "stacked_desc_kernel_vs_plain": desc_stacked,
            "stacked_file_set": "the serial run's (%d files)"
                                % len(file_sets[True])}


# ---------------------------------------------------------------------------
# The rest of the layer zoo, the TF1 parity modes, reference records and
# real-data prep (phases 10-15).

ZOO_TOL = {"forward": 1e-5, "gradient": 1e-4}  # max abs err / max|CPU ref|
DROPOUT_SHARE_TOL = 0.005  # the kept share within 0.5% of λ
REMAT_TOL = 1e-5  # ||remat - plain|| / ||plain|| over the gradient tree
# CIFAR-2's projection of the 10 classes (horse against the rest).
W_CLS = np.array([[0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
                  [1, 1, 1, 1, 1, 1, 1, 0, 1, 1]], np.float32).T
TF1_CLI_STEPS = 20


def _reset_modes():
    """Every global mode of the port off (the CLIs set them in-process)."""
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    config.set_stacked_tails(False)
    config.set_analytic_l2(False)
    config.set_pyramid_tf1(False)
    config.set_maxpool_tf1(False)
    config.set_remat(None)


def _zoo_layer_run(layer, params, x, y, cots, device):
    """Forward and backward of one layer on `device`: its output, c_err,
    c_mod and the gradients of sum(out * cot) + sum(c_err) + sum(c_mod)
    for its params and input, all on the CPU."""
    from mpnn_tpu_torch.models.net import Ctx
    p = {k: v.to(device).requires_grad_() for k, v in params.items()}
    xs = [t.to(device).requires_grad_() for t in
          (x if isinstance(x, list) else [x])]
    out, _, aux = layer.apply(p, {}, xs if isinstance(x, list) else xs[0],
                              None if y is None else y.to(device), Ctx())
    outs = out if isinstance(out, list) else [out]
    tot = sum(torch.sum(o * c.to(device)) for o, c in zip(outs, cots))
    terms = [torch.as_tensor(getattr(aux, f), device=device)
             for f in ("c_err", "c_mod")]
    tot = tot + sum(torch.sum(t) for t in terms)
    grads = torch.autograd.grad(tot, list(p.values()) + xs)
    return ([o.detach().cpu() for o in outs + terms],
            [g.cpu() for g in grads])


def zoo_layers_phase(device):
    """Each new layer of the zoo forward and backward on the card against
    the same layer on the CPU, fp32 (TF32 off), at the flagship's widths,
    batch 128; then Dropout's law and streams on the card."""
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops import layers as L
    _reset_modes()
    rng = np.random.RandomState(0)
    B = TRAIN_BATCH

    def img(*shape):
        return torch.as_tensor(rng.rand(B, *shape).astype(np.float32))

    def probs(n):
        return torch.softmax(torch.as_tensor(
            rng.standard_normal((B, n)).astype(np.float32)), 1)

    labels = torch.as_tensor(np.eye(10, dtype=np.float32)[
        rng.randint(0, 10, B)])
    pyramid = [img(32 >> k, 32 >> k, 3) for k in range(4)]
    cases = [
        ("Conv 3x3 16->32", L.Conv(n_chan=32, supp=3, k_l2=1e-4),
         img(32, 32, 16), labels, False),
        ("Conv 3x3 16->32 res", L.Conv(n_chan=32, supp=3, k_l2=1e-4,
                                      res=True), img(32, 32, 16), labels,
         False),
        ("MaxPool supp 3 stride 2", L.MaxPool(supp=3, stride=2),
         img(32, 32, 16), None, False),
        ("MaxPool supp 3 stride 2, maxpool_tf1",
         L.MaxPool(supp=3, stride=2), img(32, 32, 16), None, True),
        ("GlobalMaxPool", L.GlobalMaxPool(), img(32, 32, 16), None, False),
        ("MultiscaleLLN", L.MultiscaleLLN(), pyramid, None, False),
        ("SquaredError", L.SquaredError(), probs(10), labels, False),
        ("SuperclassCrossEntropyError",
         L.SuperclassCrossEntropyError(w_cls=W_CLS), probs(2), labels,
         False),
        ("ActivityError", L.ActivityError(α=1e-3), img(8, 8, 16), labels,
         False),
    ]
    rows = []
    for label, layer, x, y, tf1 in cases:
        config.set_maxpool_tf1(tf1)
        try:
            shape = ([tuple(t.shape[1:]) for t in x] if isinstance(x, list)
                     else tuple(x.shape[1:]))
            layer.build(shape)
            params = layer.init(torch.Generator().manual_seed(1), shape)
            out_cpu = layer.apply(params, {}, x, y, _ctx())[0]
            cots = [torch.as_tensor(rng.standard_normal(tuple(o.shape))
                                    .astype(np.float32))
                    for o in (out_cpu if isinstance(out_cpu, list)
                              else [out_cpu])]
            ref = _zoo_layer_run(layer, params, x, y, cots, "cpu")
            got = _zoo_layer_run(layer, params, x, y, cots, device)
        finally:
            config.set_maxpool_tf1(False)
        errs = {}
        for kind, a, b in (("forward",) + (got[0], ref[0]),
                           ("gradient",) + (got[1], ref[1])):
            errs[kind] = max(float((s - r).abs().max())
                             / max(float(r.abs().max()), 1e-30)
                             for s, r in zip(a, b) if r.numel()
                             and float(r.abs().max()) > 0)
            check(errs[kind] <= ZOO_TOL[kind], "zoo_layers %s: %s error %g "
                  "> %g x max|ref|" % (label, kind, errs[kind],
                                       ZOO_TOL[kind]))
        rows.append({"layer": label, "out_shape": [list(o.shape)
                                                   for o in got[0][:-2]],
                     "forward_rel_err": errs["forward"],
                     "gradient_rel_err": errs["gradient"]})
    return {"batch": B, "tolerances": ZOO_TOL, "layers": rows,
            "dropout": dropout_law(device)}


def _ctx(**kw):
    from mpnn_tpu_torch.models.net import Ctx
    return Ctx(**kw)


def dropout_law(device):
    """Dropout at λ = 0.5 on 1024 x 32 x 32 x 10 elements on the card:
    the kept share within 0.5% of λ, kept values 1/λ; the same stream and
    uid draw the same mask and another uid another; the two members of a
    stacked group with equal params on the same input draw different
    masks."""
    from mpnn_tpu_torch.models.sr import SRNet
    from mpnn_tpu_torch.models.steps import init_training
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops import layers as L
    lam = 0.5
    d = L.Dropout(λ=lam)
    d.build((32, 32, 10))
    x = torch.ones((BATCH, 32, 32, 10), device=device)
    stream = L.fold_stream(0, 1)  # (seed, t)
    outs = []
    for uid in (7, 7, 8):
        d._uid = uid
        outs.append(d.apply({}, {}, x, None, _ctx(rng=stream))[0])
    kept = outs[0] != 0
    share = float(kept.float().mean())
    check(abs(share - lam) <= DROPOUT_SHARE_TOL * lam
          and bool((outs[0][kept] == 1 / lam).all()),
          "dropout: kept share %g for λ %g" % (share, lam))
    check(torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                            outs[2]),
          "dropout: masks are not a function of (stream, uid)")

    def leaf():
        return L.Chain(name="DropReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=10), L.Dropout(λ=lam),
            L.Softmax(), L.CrossEntropyError()])

    net = SRNet(x0_shape=(8, 8, 3), y_shape=(10,), root=L.Chain(
        name="Stem", comps=[L.ToPyramid(n_scales=1)],
        sinks=(leaf(), leaf())))
    params, state, _ = init_training(net, 0, device)
    params["sinks"][1] = params["sinks"][0]
    config.set_stacked_tails(True)
    try:
        recs, _ = net.forward(params, state, torch.ones((64, 8, 8, 3),
                                                        device=device),
                              None, _ctx(train=True, rng=stream))
    finally:
        config.set_stacked_tails(False)
    a, b = (recs[l].x for l in net.leaves)
    check(len(net._stack_plan[0]["members"]) == 2 and not torch.equal(a, b),
          "dropout: the stacked members drew the same mask")
    return {"lam": lam, "elements": x.numel(), "kept_share": share,
            "same_stream_same_mask": True, "members_distinct": True}


def tf1_pyramid_phase(device):
    """ToPyramid at batch 1024 under pyramid_tf1 on the card: the CPU's
    scales exactly, each x[:, ::2^k, ::2^k]."""
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops import layers as L
    layer = L.ToPyramid(n_scales=4)
    layer.build((32, 32, 3))
    x = torch.as_tensor(np.random.RandomState(3).rand(
        BATCH, 32, 32, 3).astype(np.float32))
    config.set_pyramid_tf1(True)
    try:
        got = layer.apply({}, {}, x.to(device), None, _ctx())[0]
        ref = layer.apply({}, {}, x, None, _ctx())[0]
    finally:
        config.set_pyramid_tf1(False)
    for k, (g, r) in enumerate(zip(got, ref)):
        check(torch.equal(g.cpu(), r) and torch.equal(
            r, x[:, ::2 ** k, ::2 ** k]),
              "tf1_pyramid: scale %d differs from the CPU's or the slice"
              % k)
    return {"batch": BATCH, "scales": [list(g.shape) for g in got]}


def reference_import_phase(device, d):
    """The full-width 8-deep actor chain in the reference's exact schema
    (tests/tf1_ckpt_gen.py), read with the port's read_net under
    pyramid_tf1: a batch of 1024 served dense through the kernel against
    mcm_ref in fp32 (the serving gates, 20 launches a forward), one
    training step at batch 128 against mcm_ref (the step gates), and bf16
    dense serving timed."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.data import synth
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    from mpnn_tpu_torch.models.optim import momentum_init
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.serdes import read_net
    from tests import tf1_ckpt_gen
    _reset_modes()
    path = os.path.join(d, "reference.npy")
    tf1_ckpt_gen.write_reference_checkpoint(path, seed=0)
    config.set_pyramid_tf1(True)
    try:
        net, params, state, extra = read_net(path, device)
        check(extra is None, "reference record: unexpected extra")
        data = synth.make_synthetic(n_tr=BATCH, n_ts=BATCH, h=32, w=32,
                                    c=3, n_cls=10, seed=0)
        x0 = torch.as_tensor(data["x0_ts"], device=device)
        k_cpt = net.hypers.k_cpt
        margins = router_margins(net, params, state, [x0], k_cpt)
        # This path's launches, counted from 0 and read just after.
        fused_mcm.launches = 0
        serve(net, params, state, x0, 1.0)
        per_fwd = fused_mcm.launches
        check(per_fwd == PER_FORWARD["chain"], "reference record: %d "
              "launches a forward, expected %d" % (per_fwd,
                                                   PER_FORWARD["chain"]))
        _, served = compare_fp32("reference record", net, params, state,
                                 [x0], BATCH, 1.0, k_cpt, margins)
        vel = momentum_init(params)
        tdata = train_bench.train_data(net, device)
        k = train_once(net, params, state, vel, tdata)
        r = train_once(net, params, state, vel, tdata, _plain_stage)
        check(k["launches"] == (per_fwd, per_fwd) and r["launches"]
              == (0, 0), "reference record step: launches %s / plain %s"
              % (k["launches"], r["launches"]))
        loss_err, errs = step_gates("reference record step", k, r,
                                    zero_grad_paths(net))
        config.set_compute_dtype(torch.bfloat16)
        infer = make_routed_infer_fn(net, BATCH, capacities=1.0)
        infer(params, state, x0)
        rates = []
        for _ in range(N_WINDOWS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(N_SERVE):
                out = infer(params, state, x0)
            torch.cuda.synchronize()
            rates.append(N_SERVE * BATCH / (time.perf_counter() - t))
        check(np.isfinite(out["probs"].float().cpu().numpy()).all(),
              "reference record bf16: probs not finite")
    finally:
        _reset_modes()
    return {"record": "tests/tf1_ckpt_gen.generate_record()",
            "layers": len(list(net.layers)), "launches_per_forward": per_fwd,
            "serve_fp32_vs_plain": served, "step": {
                "batch": TRAIN_BATCH, "loss": k["loss"],
                "loss_plain": r["loss"], "loss_rel_err": loss_err,
                "errors": errs, "tolerances": TRAIN_TOL},
            "bf16_dense": {"metric": "routed-inference (dense, bf16, "
                           "reference record, batch %d)" % BATCH,
                           "value": statistics.median(rates),
                           "unit": "images/sec", "window_values": rates,
                           "window_batches": N_SERVE}}


def zoo_net(lam=0.5):
    """The flagship's first three stages (32x32x3, 10 classes) as an actor
    chain that uses every new layer: ToPyramid + MultiscaleLLN at the
    root; at stages 0 and 1 the leaf Select -> Conv -> Rect -> MaxPool ->
    Dropout -> GlobalMaxPool -> LinTrans -> Softmax -> SquaredError
    (congruent: one stack-plan group of two), at stage 2 Select ->
    LinTrans -> ActivityError -> Softmax -> SuperclassCrossEntropyError
    (w_cls 10 -> 2)."""
    from mpnn_tpu_torch import experiments as E
    from mpnn_tpu_torch.models import ActorNet
    from mpnn_tpu_torch.ops import layers as L

    def leaf():
        return L.Chain(name="ZooLeaf", comps=[
            L.Select(i=0), L.Conv(n_chan=16, supp=3, k_l2=E.k_l2, res=True),
            L.Rect(), L.MaxPool(supp=3, stride=2), L.Dropout(λ=lam),
            L.GlobalMaxPool(), L.LinTrans(n_chan=10, k_l2=E.k_l2),
            L.Softmax(), L.SquaredError()])

    root = E.rcm(2, L.Chain(name="SuperLeaf", comps=[
        L.Select(i=-1), L.LinTrans(n_chan=2, k_l2=E.k_l2),
        L.ActivityError(α=1e-3), L.Softmax(),
        L.SuperclassCrossEntropyError(w_cls=W_CLS)]))
    for i in (1, 0):
        root = E.rcm(i, leaf(), root)
    root = L.Chain(name="ToPyramid", sinks=[root], comps=[
        L.ToPyramid(n_scales=4), L.MultiscaleLLN()])
    return ActorNet(x0_shape=(32, 32, 3), y_shape=(10,), root=root,
                    k_cpt=E.k_cpts[4])


def zoo_train_phase(device):
    """One fp32 step of the zoo chain at batch 128 through the kernel
    against one through mcm_ref (the same Dropout masks: both draw them
    from the step's generator seed), at the step gates; the same with
    stacked tails (the two zoo leaves one group); then remat "full" and
    "dots" against none, with each one's peak device memory."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, _step_pieces,
                                             init_training)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    _reset_modes()
    net = zoo_net()
    params, state, vel = init_training(net, 0, device)
    data = train_bench.train_data(net, device)
    per_fwd = mcm_launches_per_forward(net)
    zero = zero_grad_paths(net)
    out = {"batch": TRAIN_BATCH, "launches_per_forward": per_fwd,
           "tolerances": TRAIN_TOL}
    try:
        for stacked in (False, True):
            config.set_stacked_tails(stacked)
            k = train_once(net, params, state, vel, data)
            r = train_once(net, params, state, vel, data, _plain_stage)
            label = "zoo_train%s" % (" stacked" if stacked else "")
            check(k["launches"] == (per_fwd, per_fwd)
                  and r["launches"] == (0, 0), "%s: launches %s, expected "
                  "%d a forward" % (label, k["launches"], per_fwd))
            loss_err, errs = step_gates(label, k, r, zero)
            out["stacked" if stacked else "serial"] = {
                "loss": k["loss"], "loss_plain": r["loss"],
                "loss_rel_err": loss_err, "errors": errs}
        check([len(g["members"]) for g in net._stack_plan] == [2],
              "zoo_train: expected one stack-plan group of two leaves")
        config.set_stacked_tails(False)
        batch_ctx, loss_and_grads = _step_pieces(
            net, TRAIN_BATCH, Schedules(lr=λ_lrn, tau=τ_ds), 4, False)
        remat, launches = {}, {}
        for policy in (None, "full", "dots"):
            config.set_remat(policy)
            gen = torch.Generator(device=device).manual_seed(0)
            xb, yb, ctx = batch_ctx(0, gen, *data, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            fused_mcm.launches = 0
            loss, _, _, grads = loss_and_grads(params, state, xb, yb, ctx)
            torch.cuda.synchronize()
            launches[policy] = fused_mcm.launches
            peak = torch.cuda.max_memory_allocated(device)
            remat[policy] = (float(loss), grads, peak, peak - base)
        # "dots" saves the stage operator's outputs: its backward
        # relaunches nothing; "full" recomputes every stage.
        check(launches["dots"] == launches[None] == per_fwd
              and launches["full"] == 2 * per_fwd, "zoo_train remat: "
              "launches %s, expected none = dots = %d, full = %d"
              % (launches, per_fwd, 2 * per_fwd))
        rows = {}
        for policy in ("full", "dots"):
            e = tree_errs(remat[policy][1], remat[None][1], zero)
            check(e["tree"] <= REMAT_TOL, "zoo_train remat %s: gradients "
                  "%g from none's > %g" % (policy, e["tree"], REMAT_TOL))
            rows[policy] = {"gradient_rel_err": e["tree"],
                            "worst_leaf_rel_err": e["leaf"],
                            "loss": remat[policy][0],
                            "peak_bytes": remat[policy][2],
                            "peak_bytes_above_start": remat[policy][3],
                            "launches": launches[policy]}
        rows["none"] = {"loss": remat[None][0],
                        "peak_bytes": remat[None][2],
                        "peak_bytes_above_start": remat[None][3],
                        "launches": launches[None]}
        out["remat"] = rows
    finally:
        _reset_modes()
    return out


def _cli_run(main, argv):
    """main(argv) in this process, stdout captured, the global modes reset
    after; returns (stdout, its fused_mcm launches, seconds)."""
    import contextlib
    import io
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    buf = io.StringIO()
    t = time.perf_counter()
    # The path's launches are counted from 0 here and read just after.
    fused_mcm.launches = fused_mcm.net_launches = 0
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
    finally:
        _reset_modes()
    return buf.getvalue(), fused_mcm.launches, time.perf_counter() - t


def tf1_cli_phase(device, d):
    """The CLIs with the TF1 modes on the small synthetic archives, fp32,
    batch 128, to 20 steps: `train synth-ac --net 4 --pyramid-tf1` and
    `train_adaptive synth-ac-dynkcpt --pyramid-tf1 --maxpool-tf1`. Gates:
    the files, and launches = 20 x (steps + evaluations x eval batches)."""
    from mpnn_tpu_torch import train as cli
    from mpnn_tpu_torch import train_adaptive
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.data.prep import make_synthetic_archives
    from mpnn_tpu_torch.experiments import k_cpts
    make_synthetic_archives(os.path.join(d, "data"), small=True)
    ds = Dataset(os.path.join(d, "data", "synth.npz"), device=device)
    eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                       for x in (ds.x0_tr, ds.x0_ts))
    common = ["--n-iter", str(TF1_CLI_STEPS), "--t-log", str(TF1_CLI_STEPS),
              "--batch-size", str(TRAIN_BATCH), "--data-root", d,
              "--out-root", os.path.join(d, "nets"),
              "--device", str(device)]
    runs = [("train synth-ac --net 4 --pyramid-tf1", cli.main,
             ["synth-ac", "--net", "4", "--pyramid-tf1"], 1,
             ["0004.npy", "0004-stats.npy", "0004-log.txt",
              "0004-stats/%.8i.npy" % TF1_CLI_STEPS, "MANIFEST.json"]),
            ("train_adaptive synth-ac-dynkcpt --pyramid-tf1 --maxpool-tf1",
             train_adaptive.main, ["synth-ac-dynkcpt", "--pyramid-tf1",
                                   "--maxpool-tf1"], len(k_cpts),
             ["net.npy", "MANIFEST.json"] + ["%.4i-stats.npy" % i
                                             for i in range(len(k_cpts))])]
    rows, total = [], 0
    for label, main, argv, evals, files in runs:
        stdout, launches, secs = _cli_run(main, argv + common)
        expect = PER_FORWARD["chain"] * (TF1_CLI_STEPS
                                         + evals * eval_batches)
        out_dir = os.path.join(d, "nets", argv[0])
        missing = [f for f in files
                   if not os.path.exists(os.path.join(out_dir, f))]
        check(not missing and launches == expect, "tf1_cli %s: %d launches "
              "(expected %d), missing %s" % (label, launches, expect,
                                             missing))
        row = {"run": label, "steps": TF1_CLI_STEPS, "evals": evals,
               "eval_batches": eval_batches, "launches": launches,
               "seconds": secs}
        if main is train_adaptive.main:
            tm = json.loads(stdout.strip().splitlines()[-1])
            check(tm["fused_mcm_launches"] == launches, "tf1_cli: the "
                  "adaptive CLI reports %d launches" %
                  tm["fused_mcm_launches"])
            row["train_s"] = tm["train_s"]
        rows.append(row)
        total += launches
    return {"runs": rows, "fused_mcm_launches": total}


def prep_files_phase(device, d):
    """Real-format fixtures (a scipy .mat of 300 train / 50 test digits
    per class, the cifar-10-batches-mat gztar with 300 rows a batch)
    through the port's prepare_from_files, then `train hybrid-ac --net 4`
    to 20 steps on the card from the hybrid.npz it wrote."""
    import tarfile
    import scipy.io as sio
    from mpnn_tpu_torch import train as cli
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.data.prep import prepare_from_files
    rng = np.random.RandomState(0)
    mat = os.path.join(d, "mnist_all.mat")
    sio.savemat(mat, {"%s%d" % (s, i): (rng.rand(n, 784) * 255).astype(
        np.uint8) for i in range(10) for s, n in (("train", 300),
                                                  ("test", 50))})
    bdir = os.path.join(d, "cifar-10-batches-mat")
    os.makedirs(bdir)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        sio.savemat(os.path.join(bdir, name + ".mat"), {
            "data": (rng.rand(300, 3072) * 255).astype(np.uint8),
            "labels": rng.randint(0, 10, (300, 1))})
    tgz = os.path.join(d, "cifar-10-matlab.tar.gz")
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(bdir, arcname="cifar-10-batches-mat")
    t = time.perf_counter()
    names = prepare_from_files(os.path.join(d, "data"), mat, tgz,
                               verbose=False)
    prep_s = time.perf_counter() - t
    ds = Dataset(os.path.join(d, "data", "hybrid.npz"), device=device)
    check(names == ["cifar-10.npz", "cifar-2.npz", "cifar-5.npz",
                    "hybrid.npz", "mnist.npz"]
          and tuple(ds.x0_shape) == (32, 32, 3) and ds.provenance
          and not ds.provenance["synthetic"], "prep_files: archives %s, "
          "hybrid %s" % (names, ds.x0_shape))
    eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                       for x in (ds.x0_tr, ds.x0_ts))
    stdout, launches, secs = _cli_run(cli.main, [
        "hybrid-ac", "--net", "4", "--n-iter", str(TF1_CLI_STEPS),
        "--t-log", str(TF1_CLI_STEPS), "--batch-size", str(TRAIN_BATCH),
        "--data-root", d, "--out-root", os.path.join(d, "nets"),
        "--device", str(device)])
    expect = PER_FORWARD["chain"] * (TF1_CLI_STEPS + eval_batches)
    ckpt = os.path.join(d, "nets", "hybrid-ac", "0004.npy")
    check(launches == expect and os.path.exists(ckpt), "prep_files: %d "
          "launches (expected %d), checkpoint %s" % (launches, expect,
                                                     os.path.exists(ckpt)))
    return {"archives": names, "hybrid_tr": len(ds.x0_tr),
            "hybrid_ts": len(ds.x0_ts), "prep_s": prep_s,
            "train": {"run": "train hybrid-ac --net 4",
                      "steps": TF1_CLI_STEPS, "eval_batches": eval_batches,
                      "launches": launches, "seconds": secs},
            "fused_mcm_launches": launches}


ADAPTIVE_CHECKPOINT = os.path.join(HERE, "results", "nets",
                                   "hybrid-ac-dynkcpt", "net.npy")
CPU_CANARY_BATCH = 64  # images the fp32 artifact serves on the CPU
N_EXPORT_WINDOWS = 2  # timed windows, artifact / direct
N_EXPORT_BATCHES = 10  # batches per timed window of an artifact
PARITY_BATCH = 8  # test images of check_parity on the trained flagship
CHILD_TIMEOUT_S = 600  # a process of 7f other than the CLIs, from its check
# Loads and serves an artifact in a process that cannot import jax,
# mpnn_tpu, or the port's models, utils and experiments; argv: artifact,
# input batch (.npy), output (.npz), and the price for a dyn_k_cpt one.
_ARTIFACT_CHILD = """import sys
for m in ("jax", "mpnn_tpu", "mpnn_tpu_torch.models", "mpnn_tpu_torch.utils",
          "mpnn_tpu_torch.experiments"):
    sys.modules[m] = None
import numpy as np, torch
from mpnn_tpu_torch.export import serve_fn
from mpnn_tpu_torch.ops.kernels import fused_mcm
x = torch.as_tensor(np.load(sys.argv[2]), device="cuda")
args = (x,) + tuple(torch.tensor(float(k), device="cuda")
                    for k in sys.argv[4:])
fused_mcm.launches = 0
out = serve_fn(sys.argv[1])(*args)
torch.cuda.synchronize()
np.savez(sys.argv[3], launches=fused_mcm.launches,
         **{k: v.cpu().numpy() for k, v in out.items()})
"""


def _same_outputs(label, got, want, tol=1e-5):
    """An artifact's outputs against the direct engine's on the same batch:
    exit_idx, ops and forced equal, probs within tol; returns the probs'
    max abs difference."""
    got = {k: np.asarray(v.float().cpu() if torch.is_tensor(v) else v)
           for k, v in got.items()}
    want = {k: v.float().cpu().numpy() for k, v in want.items()}
    for k in ("exit_idx", "ops", "forced"):
        check(np.array_equal(got[k], want[k]), "%s: %s differ on %d rows"
              % (label, k, int((got[k] != want[k]).sum())))
    err = float(np.abs(got["probs"] - want["probs"]).max())
    check(err <= tol, "%s: probs differ by %g > %g" % (label, err, tol))
    return err


def _export_and_load(net, params, state, d, name, **kw):
    """Trace, save and load an artifact: (callable, export seconds, file
    bytes, load seconds)."""
    from mpnn_tpu_torch import export as ex
    t = time.perf_counter()
    ep = ex.export_infer(net, params, state, **kw)
    export_s = time.perf_counter() - t
    path = os.path.join(d, name)
    ex.save_artifact(ep, path)
    t = time.perf_counter()
    fn = ex.serve_fn(path)
    load_s = time.perf_counter() - t
    return fn, path, {"export_s": export_s, "bytes": os.path.getsize(path),
                      "load_s": load_s}


def _served(label, fn, direct, xs, per_batch, *price):
    """Each batch of xs through the artifact (its launches counted from 0)
    and the direct engine: the same outputs, per_batch launches a batch;
    returns (max probs difference, mean ops, exit histogram)."""
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    errs, ops, exits = [], [], []
    for x in xs:
        fused_mcm.launches = 0
        got = fn(x, *price)
        torch.cuda.synchronize()
        check(fused_mcm.launches == per_batch, "%s: %d launches a batch, "
              "expected %d" % (label, fused_mcm.launches, per_batch))
        errs.append(_same_outputs(label, got, direct(x, *price)))
        ops.append(got["ops"].cpu().numpy())
        exits.append(got["exit_idx"].cpu().numpy())
    return (max(errs), float(np.concatenate(ops).mean()),
            np.bincount(np.concatenate(exits)).tolist())


def _rates(fns, x, *price):
    """img/s of each callable: N_EXPORT_WINDOWS windows of N_EXPORT_BATCHES
    batches, the callables in turns; {name: (median, windows)}."""
    rates = {name: [] for name in fns}
    for _ in range(N_EXPORT_WINDOWS):
        for name, fn in fns.items():
            t = time.perf_counter()
            for _ in range(N_EXPORT_BATCHES):
                fn(x, *price)
            torch.cuda.synchronize()
            rates[name].append(N_EXPORT_BATCHES * x.shape[0]
                               / (time.perf_counter() - t))
    return {name: {"img_s": statistics.median(r), "window_values": r}
            for name, r in rates.items()}


def start_artifact_child(d, path, x, *price):
    """The artifact at `path` loaded and served on x by _ARTIFACT_CHILD, in
    a process of its own, its files in d: (process, output path, start
    time) for `artifact_child_phase`."""
    import subprocess
    np.save(os.path.join(d, "x.npy"), x.cpu().numpy())
    out = os.path.join(d, "child.npz")
    with open(os.path.join(d, "child.err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _ARTIFACT_CHILD, path,
             os.path.join(d, "x.npy"), out] + ["%r" % float(p) for p in price],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.DEVNULL, stderr=err)
    return proc, out, time.perf_counter()


def artifact_child_phase(label, started, want, per_batch):
    """The process `start_artifact_child` started: exit 0, its outputs
    equal the direct engine's (`want`), with per_batch launches; its
    seconds from start to this check."""
    import subprocess
    proc, out, t = started
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    secs = time.perf_counter() - t
    with open(os.path.join(os.path.dirname(out), "child.err")) as f:
        err = f.read()
    check(rc == 0, "%s: the artifact's process failed:\n%s"
          % (label, err[-4000:]))
    got = dict(np.load(out))
    check(int(got.pop("launches")) == per_batch, "%s: the process launched "
          "the kernel %s times" % (label, got.get("launches")))
    return {"max_prob_err": _same_outputs(label, got, want),
            "process_s": secs}


def export_chain_phase(device, caps, d):
    """The trained flagship exported at the serving batch in bf16 at
    serve_bf16's calibrated capacities, saved into d, loaded and served
    against the direct engine (the synthetic batches serve_phase serves),
    with 20 launches a batch; an fp32 export moved to the CPU against the
    CPU engine on CPU_CANARY_BATCH images. Returns the record and, for
    `start_artifact_child` (the same file served by a process that
    cannot import jax or the port's model code), the artifact's path, a
    batch and the direct engine's outputs on it."""
    from mpnn_tpu_torch.data import synth
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.serdes import read_net
    from mpnn_tpu_torch import export as ex
    B = BATCH
    net, params, state, _ = read_net(CHECKPOINT, device)
    h, w, c = net.hypers.x0_shape
    data = synth.make_synthetic(n_tr=B, n_ts=B, h=h, w=w, c=c,
                                n_cls=int(net.hypers.y_shape[0]), seed=0)
    xs = [torch.as_tensor(data[k], device=device) for k in ("x0_ts",
                                                            "x0_tr")]
    per_batch = PER_FORWARD["chain"]
    out = {"checkpoint": os.path.relpath(CHECKPOINT, HERE), "batch": B,
           "capacities": caps, "precision": "bf16"}
    config.set_compute_dtype(torch.bfloat16)
    try:
        fn, path, out["artifact"] = _export_and_load(
            net, params, state, d, "chain.pt2", batch_size=B,
            capacities=caps)
        infer = make_routed_infer_fn(net, B, capacities=caps)

        def direct(x):
            return infer(params, state, x)
        err, mean_ops, hist = _served("export_chain", fn, direct, xs,
                                      per_batch)
        out.update(max_prob_err=err, mean_ops=mean_ops, exit_hist=hist,
                   launches_per_batch=per_batch,
                   rates=_rates({"artifact": fn, "direct": direct},
                                xs[0]))
        fresh = (path, xs[0], {k: v.cpu()
                               for k, v in direct(xs[0]).items()})
    finally:
        config.set_compute_dtype(None)
    # fp32, traced on the card, moved to the CPU and served there.
    n = CPU_CANARY_BATCH
    t = time.perf_counter()
    ep = ex.export_infer(net, params, state, batch_size=n,
                         capacities=caps)
    art32 = {"export_s": time.perf_counter() - t}
    path = os.path.join(d, "chain32.pt2")
    ex.save_artifact(ep, path)
    t = time.perf_counter()
    canary = ex.serve_fn(path, "cpu")
    art32.update(bytes=os.path.getsize(path),
                 load_s=time.perf_counter() - t)
    cnet, cp, cs, _ = read_net(CHECKPOINT, "cpu")
    x = xs[0][:n].cpu()
    got = {k: v.numpy() for k, v in canary(x).items()}
    want = {k: v.numpy() for k, v in make_routed_infer_fn(
        cnet, n, capacities=caps)(cp, cs, x).items()}
    margins = router_margins(cnet, cp, cs, [x], cnet.hypers.k_cpt)
    paths = tree_paths(cnet)
    near_tie = np.array([(margins[e, paths[want["exit_idx"][e]]]
                          < MARGIN_TIE).any() for e in range(n)])
    same = got["exit_idx"] == want["exit_idx"]
    check(not (~(same & (got["ops"] == want["ops"])) & ~near_tie).any(),
          "export_chain cpu: exits differ outside router near-ties")
    err = float(np.abs(got["probs"] - want["probs"])[same].max())
    check(err <= 1e-4, "export_chain cpu: probs differ by %g" % err)
    out["cpu_canary"] = {"batch": n, "precision": "fp32",
                         "artifact": art32, "max_prob_err": err,
                         "exit_mismatches": int((~same).sum()),
                         "near_tie_examples": int(near_tie.sum())}
    return out, fresh


def export_adaptive_phase(device, data):
    """The trained adaptive chain exported as one dyn_k_cpt artifact
    (bf16, the serving batch, capacities calibrated at price 0 on the
    train split of the rebuilt hybrid.npz), served on the first test
    batch at each of the 8 prices of its registry entry against the
    direct engine, 20 launches a batch; mean ops at the dearest price
    at most that at price 0."""
    import tempfile
    from mpnn_tpu_torch.experiments import k_cpts
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.serdes import read_net
    B = BATCH
    net, params, state, _ = read_net(ADAPTIVE_CHECKPOINT, device)
    check(net.hypers.dyn_k_cpt, "export_adaptive: not a dyn_k_cpt net")
    x = torch.as_tensor(data["x0_ts"][:B], device=device)
    x_cal = torch.as_tensor(data["x0_tr"][:B], device=device)
    out = {"checkpoint": os.path.relpath(ADAPTIVE_CHECKPOINT, HERE),
           "batch": B, "precision": "bf16"}
    config.set_compute_dtype(torch.bfloat16)
    try:
        caps = calibrate_capacities(net, params, state, x_cal,
                                    k_cpt=torch.tensor(0.0, device=device))
        infer = make_routed_infer_fn(net, B, capacities=caps)

        def direct(x, k):
            return infer(params, state, x, k)
        with tempfile.TemporaryDirectory() as d:
            fn, _, out["artifact"] = _export_and_load(
                net, params, state, d, "adaptive.pt2", batch_size=B,
                capacities=caps, dyn_k_cpt=True)
            prices = []
            for k_cpt in k_cpts:
                k = torch.tensor(k_cpt, device=device)
                err, mean_ops, hist = _served(
                    "export_adaptive k_cpt %g" % k_cpt, fn, direct, [x],
                    PER_FORWARD["chain"], k)
                prices.append({"k_cpt": k_cpt, "max_prob_err": err,
                               "mean_ops": mean_ops, "exit_hist": hist})
            out["rates_at_k_cpt"] = k_cpts[4]
            out["rates"] = _rates({"artifact": fn, "direct": direct}, x,
                                  torch.tensor(k_cpts[4], device=device))
    finally:
        config.set_compute_dtype(None)
    check(prices[-1]["mean_ops"] <= prices[0]["mean_ops"],
          "export_adaptive: mean ops at the dearest price %g > at price 0 "
          "%g" % (prices[-1]["mean_ops"], prices[0]["mean_ops"]))
    out.update(capacities=caps, per_k_cpt=prices,
               launches_per_batch=PER_FORWARD["chain"])
    return out


def export_tree_phase(device, tree):
    """The trained adaptive tree (tree_serve's) exported as one dyn_k_cpt
    artifact (bf16, the serving batch, capacities calibrated at price 0),
    served on the first test batch at each of its 8 prices against the
    direct engine, 96 launches a batch; its export seconds."""
    import tempfile
    from mpnn_tpu_torch.experiments import k_cpts
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    net, params, state, _, data = tree
    B = BATCH
    x = torch.as_tensor(data["x0_ts"][:B], device=device)
    x_cal = torch.as_tensor(data["x0_tr"][:B], device=device)
    out = {"checkpoint": os.path.relpath(TREE_CHECKPOINT, HERE),
           "batch": B, "precision": "bf16"}
    config.set_compute_dtype(torch.bfloat16)
    try:
        caps = calibrate_capacities(net, params, state, x_cal,
                                    k_cpt=torch.tensor(0.0, device=device))
        infer = make_routed_infer_fn(net, B, capacities=caps)

        def direct(x, k):
            return infer(params, state, x, k)
        with tempfile.TemporaryDirectory() as d:
            fn, _, out["artifact"] = _export_and_load(
                net, params, state, d, "tree.pt2", batch_size=B,
                capacities=caps, dyn_k_cpt=True)
            prices = []
            for k_cpt in k_cpts:
                err, mean_ops, hist = _served(
                    "export_tree k_cpt %g" % k_cpt, fn, direct, [x],
                    PER_FORWARD["tree"], torch.tensor(k_cpt, device=device))
                prices.append({"k_cpt": k_cpt, "max_prob_err": err,
                               "mean_ops": mean_ops})
    finally:
        config.set_compute_dtype(None)
    out.update(capacities=caps, per_k_cpt=prices,
               launches_per_batch=PER_FORWARD["tree"])
    return out


def start_parity_cli(d, data):
    """`python -m mpnn_tpu_torch.check_parity --grads` on the flagship and
    PARITY_BATCH test images of `data`, in a process of its own, its
    archive and output in d: (process, output paths, start time) for
    `parity_phase`."""
    import subprocess
    n = PARITY_BATCH
    arch = os.path.join(d, "parity.npz")
    np.savez(arch, {k: data[k][:n] for k in ("x0_tr", "x0_ts", "y_tr",
                                              "y_ts")}
             | {"m_sym": data["m_sym"]})
    outs = [os.path.join(d, "parity." + x) for x in ("out", "err")]
    with open(outs[0], "w") as out, open(outs[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mpnn_tpu_torch.check_parity", CHECKPOINT,
             "--data", arch, "--batch-size", str(n), "--grads"], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE), stdout=out, stderr=err,
            text=True)
    return proc, outs, time.perf_counter()


PROCESS_FLAG = "--phase-process"  # argv[1] of a phase's own process


def start_phase_process(name, d):
    """`python3 chip_smoke.py --phase-process NAME d`: the phase NAME of
    PROCESS_PHASES in a process of its own, its inputs and record in d:
    (process, d, name, start time) for `phase_process_result`. The smoke
    runs host-bound phases that time no rate so, beside those of 7f."""
    import subprocess
    with open(os.path.join(d, name + ".err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), PROCESS_FLAG, name,
             d], cwd=HERE, stdout=subprocess.DEVNULL, stderr=err)
    return proc, d, name, time.perf_counter()


def phase_process(name, d, device=None):
    """The body of `start_phase_process`'s process: the phase's record
    written to d/NAME.json (the phase raises if a gate fails)."""
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = PROCESS_PHASES[name](device or torch.device("cuda", 0), d)
    with open(os.path.join(d, name + ".json"), "w") as f:
        json.dump(rec, f)


def phase_process_result(started):
    """The record a `start_phase_process` process wrote (it exits 0 only
    if its gates hold), with its seconds from start to this check."""
    import subprocess
    proc, d, name, t = started
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    with open(os.path.join(d, name + ".err")) as f:
        err = f.read()
    check(rc == 0, "%s: its process exited %d:\n%s" % (name, rc, err[-4000:]))
    with open(os.path.join(d, name + ".json")) as f:
        rec = json.load(f)
    return dict(rec, process_s=time.perf_counter() - t)


def start_export_tree(d, data):
    """export_tree_phase in a process of its own, on the first train and
    test batches of `data`, written to d."""
    np.savez(os.path.join(d, "batches.npz"),
             **{k: data[k][:BATCH] for k in ("x0_tr", "x0_ts")})
    return start_phase_process("export_tree", d)


def _export_tree_in(device, d):
    """export_tree_phase of the trained tree read from TREE_CHECKPOINT,
    on `start_export_tree`'s batches."""
    from mpnn_tpu_torch.utils.serdes import read_net
    net, params, state, extra = read_net(TREE_CHECKPOINT, device)
    data = dict(np.load(os.path.join(d, "batches.npz")))
    return export_tree_phase(device, (net, params, state, extra["t"], data))


PROCESS_PHASES = {"export_tree": _export_tree_in,
                  "train_cli": lambda device, d: train_cli_phase(device)}


def parity_phase(device, data, cli):
    """check_parity and check_grad_parity of the trained flagship on
    PARITY_BATCH test images of the rebuilt hybrid.npz, fp32 on the kernel
    path (TF32 off), against the float64 oracle: both ok, 20 launches a
    forward; under a bf16 compute dtype check_parity must fail (the
    negative control); then the process `start_parity_cli` started
    (`python -m mpnn_tpu_torch.check_parity --grads` on the same
    checkpoint and images): exit 0 and PARITY OK."""
    import subprocess
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.paritycheck import check_grad_parity, check_parity
    from mpnn_tpu_torch.utils.serdes import read_net
    n = PARITY_BATCH
    net, params, state, _ = read_net(CHECKPOINT, device)
    x0, y = data["x0_ts"][:n], data["y_ts"][:n]
    config.set_compute_dtype(None)
    reports = {}
    for name, fn in (("forward", check_parity),
                     ("grad", check_grad_parity)):
        fused_mcm.launches = 0
        t = time.perf_counter()
        rep = fn(net, params, state, x0, y)
        torch.cuda.synchronize()
        rep["seconds"] = time.perf_counter() - t
        rep["launches"] = fused_mcm.launches
        check(rep["ok"], "parity %s: %s" % (name, json.dumps(rep)))
        check(rep["launches"] == PER_FORWARD["chain"], "parity %s: %d "
              "launches" % (name, rep["launches"]))
        reports[name] = rep
    config.set_compute_dtype(torch.bfloat16)
    try:
        neg = check_parity(net, params, state, x0, y)
    finally:
        config.set_compute_dtype(None)
    check(not neg["ok"], "parity: the bf16 negative control passed")
    reports["bf16_negative_control"] = {
        "ok": neg["ok"], "failed": sorted(k for k, v in neg["checks"].items()
                                          if not v["ok"])}
    proc, outs, t = cli
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    secs = time.perf_counter() - t
    texts = []
    for f in outs:
        with open(f) as fh:
            texts.append(fh.read())
    stdout, stderr = texts
    lines = stdout.strip().splitlines()
    check(rc == 0 and lines and lines[-1] == "PARITY OK",
          "parity: check_parity process exit %d, last line %r\n%s"
          % (rc, lines[-1] if lines else None, stderr[-4000:]))
    reports["cli"] = {"exit": rc, "last_line": lines[-1], "seconds": secs}
    reports.update(checkpoint=os.path.relpath(CHECKPOINT, HERE), batch=n,
                   data="hybrid.npz rebuilt, test split")
    return reports


def compact_phase(device, tree):
    """The trained tree's compact archive read, rewritten by the port's
    write_compact into a temporary directory and read back: every array
    equal bit for bit; the net decoded from the rewritten archive serves
    one batch (fp32, dense, price k_cpts[4]) with the original's exits,
    its params equal to the original's bit for bit, probs within 1e-5."""
    import tempfile
    from mpnn_tpu_torch.experiments import k_cpts
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.serdes import (compact_src_sha, decode_net,
                                             read_compact, write_compact)
    from mpnn_tpu_torch.utils.tree import tree_leaves
    net, params, state, _, data = tree
    t = time.perf_counter()
    rec = read_compact(TREE_CHECKPOINT)
    read_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        manifest = write_compact(d, rec, src_sha="0" * 64)
        write_s = time.perf_counter() - t
        back = read_compact(d)
        sha = compact_src_sha(d)
    check(_records_equal(back, rec) and sha == "0" * 64,
          "compact: the rewritten archive does not read back bit for bit")
    net2, p2, s2, _ = decode_net(back, device)
    same_params = all(torch.equal(u, v) for u, v in zip(
        tree_leaves((params, state)), tree_leaves((p2, s2))))
    x = torch.as_tensor(data["x0_ts"][:BATCH], device=device)
    config.set_compute_dtype(None)
    a = serve(net, params, state, x, 1.0, k_cpt=k_cpts[4])
    b = serve(net2, p2, s2, x, 1.0, k_cpt=k_cpts[4])
    exit_mismatches = int((a["exit_idx"] != b["exit_idx"]).sum())
    prob_err = float(np.abs(a["probs"] - b["probs"]).max())
    # The same params in other allocations: cuBLAS may take another
    # kernel for another alignment, so probs may move by an fp32 rounding.
    check(same_params and exit_mismatches == 0 and prob_err <= 1e-5,
          "compact: the rewritten net (params equal: %s) serves "
          "differently: %d exits differ, probs by %g"
          % (same_params, exit_mismatches, prob_err))
    return {"checkpoint": os.path.relpath(TREE_CHECKPOINT, HERE),
            "read_s": read_s, "write_s": write_s,
            "params_equal": same_params, "exit_mismatches": exit_mismatches,
            "max_prob_err": prob_err, "parts": len(manifest["parts"]),
            "bytes": sum(p["bytes"] for p in manifest["parts"]),
            "committed_bytes": sum(
                os.path.getsize(os.path.join(TREE_CHECKPOINT, f))
                for f in os.listdir(TREE_CHECKPOINT) if f.startswith("part-")),
            "served_examples": BATCH}


# Parallelism (phases 16-20): the ranks of a mesh, each a process of its
# own on the one card, sharing it over gloo (NCCL refuses two ranks on one
# GPU), and world size 1 over NCCL.
DP_RANKS = 2
DP_WINDOWS = (2, 5)  # timed windows x steps of dp_train
MESH_CLI_STEPS = 1  # steps of the mesh CLI runs (one-step gates; see PERF.md)
MESH_TIMEOUT_S = 300  # a CLI run over ranks, start to end
ROUTE_REPS = 5  # timed calls of each of sweep_remat's gradient routes
# The velocity gates of sweep_mesh's checkpoints: TRAIN_TOL's, but 5e-3
# over the tree. After one step the velocity is the gradient after TALR,
# which scales the deepest nodes' gradients (p_tr near the eps floor) until
# they dominate the tree, and those are ill-conditioned in fp32. A 2x1 sweep
# mesh reduces nothing across ranks, but each rank's vmap is 4 nets wide
# against the meshless 8, and the backward's grouped convolutions (one
# group a net) are other calls at each width: on an H100 the meshless
# step at 4 against 8 wide reads 2.0e-5 to 6.5e-4 over a member's
# velocity tree (`sweep_width_gap`; run to run 2.1e-7 to 3.5e-7), and the
# CLI's mesh against meshless 3.6e-5 to 2.15e-3 (PERF.md, PR 15); the
# bound is 2.3x the largest.
SWEEP_MESH_VEL_TOL = dict(TRAIN_TOL, tree=5e-3)
JOIN_TIMEOUT_S = 120  # a rank joining, or waiting in a collective


@contextlib.contextmanager
def _counting_all_reduce(groups=None):
    """torch.distributed.all_reduce (which mesh and steps call through the
    module) wrapped to count its calls and their host seconds, in the
    dict yielded, until the block ends; with groups ({name: process
    group or None}), also by_group[name] = [calls, host seconds] of the
    calls over each group that is not None."""
    import torch.distributed as dist
    groups = groups or {}
    counts = {"calls": 0, "host_s": 0.0,
              "by_group": {name: [0, 0.0] for name in groups}}
    inner = dist.all_reduce

    def all_reduce(*args, **kwargs):
        t = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t
            counts["host_s"] += dt
            counts["calls"] += 1
            for name, g in groups.items():
                if g is not None and kwargs.get("group") is g:
                    counts["by_group"][name][0] += 1
                    counts["by_group"][name][1] += dt

    dist.all_reduce = all_reduce
    try:
        yield counts
    finally:
        dist.all_reduce = inner


def _dp_rank(rank, n_ranks, port, out_dir):
    """One rank of dp_train: the flagship at batch TRAIN_BATCH over a data
    mesh of every rank, one step (`train_once`) and the timed windows
    (`make_train_loop`, its launches counted from 0), written to
    out_dir/rank<r>.pt for the parent."""
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_loop
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.parallel import make_mesh, multihost
    from mpnn_tpu_torch.utils.tree import tree_map
    multihost.initialize("127.0.0.1:%d" % port, n_ranks, rank,
                         timeout_s=JOIN_TIMEOUT_S)
    try:
        import torch.distributed as dist
        device = multihost.local_device()
        config.set_compute_dtype(None)
        net, params, state, vel = train_bench.build(0, device)
        data = train_bench.train_data(net, device)
        mesh = make_mesh()
        one = train_once(net, params, state, vel, data, mesh=mesh)
        one["rows"] = list(mesh.data.rows(TRAIN_BATCH))
        loop = make_train_loop(net, TRAIN_BATCH,
                               Schedules(lr=λ_lrn, tau=τ_ds), mesh=mesh)
        trees = (params, state, vel)
        trees = loop(*trees, 0, 1, *data, 2)[:3]  # warm-up
        n_windows, n_steps = DP_WINDOWS
        t, windows = 2, []
        with _counting_all_reduce() as counts:
            fused_mcm.launches = 0  # the main path, counted from 0
            for _ in range(n_windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trees = loop(*trees, t, 1, *data, n_steps)[:3]
                torch.cuda.synchronize()
                windows.append(time.perf_counter() - t0)
                t += n_steps
        steps = n_windows * n_steps
        rec = {"rank": rank, "backend": dist.get_backend(),
               "device": str(device), "mesh": mesh.shape,
               "one": tree_map(lambda a: a.cpu() if torch.is_tensor(a)
                               else a, one),
               "launches": fused_mcm.launches, "steps": steps,
               "all_reduces": counts["calls"],
               "all_reduce_host_s": counts["host_s"],
               "window_s": windows}
    finally:
        multihost.shutdown()
    torch.save(rec, os.path.join(out_dir, "rank%d.pt" % rank))


def _start_ranks(fn, n_ranks, *args):
    """Run fn(rank, n_ranks, port, out_dir, *args) in n_ranks processes
    (spawn) and return what each wrote to out_dir/rank<r>.pt; a rank that
    fails fails the phase (and stops the others)."""
    import tempfile
    import torch.multiprocessing as mp
    from mpnn_tpu_torch.parallel.multihost import free_port
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(fn, args=(n_ranks, free_port(), d) + args,
                           nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, "rank%d.pt" % r),
                           map_location="cpu", weights_only=False)
                for r in range(n_ranks)]


def _to_cpu(rec):
    from mpnn_tpu_torch.utils.tree import tree_map
    return tree_map(lambda a: a.cpu() if torch.is_tensor(a) else a, rec)


def rank_stage_check(device, batch, label):
    """The flagship's eight stages at a rank's batch through the kernel
    against mcm_ref (fp32, TOL) and float64 (F64_TOL): the worst errors."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import stage_inputs
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref
    config.set_compute_dtype(None)
    err = rel = rel64 = 0.0
    for i, (xs, whs, wvs, bs, _) in enumerate(stage_inputs(
            arch, batch, 32, seed=5, device=device)):
        out = fused_mcm(xs, whs, wvs, bs, 3)
        ref = mcm_ref(xs, whs, wvs, bs)
        torch.cuda.synchronize()
        e = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        scale = max(float(r.abs().max()) for r in ref)
        check(e <= TOL["fp32"] * scale, "%s stage %d batch %d: max abs err "
              "%g > %g * max|ref| %g" % (label, i, batch, e, TOL["fp32"],
                                         scale))
        err, rel = max(err, e), max(rel, e / scale)
        rel64 = max(rel64, check_f64("%s stage %d batch %d" % (
            label, i, batch), out, xs, whs, wvs, bs)["rel_err_vs_f64"])
    return {"batch": batch, "max_abs_err": err, "max_rel_err": rel,
            "max_rel_err_vs_f64": rel64}


def dp_train_phase(device, single_fp32):
    """dp_train: the flagship actor chain at k_cpts[4], global batch
    TRAIN_BATCH in fp32, over a data mesh of DP_RANKS ranks sharing the
    card over gloo: one step against the single-process kernel step at
    the same batch (`train_once`) at train_fp32_vs_plain's gates, every
    rank's params equal after it, PER_FORWARD launches per forward on each
    rank; then DP_WINDOWS timed windows: img/s over the global batch, the
    all-reduces a step and their host seconds, and each rank's launches
    counted from 0 against PER_FORWARD x steps. The kernel at a rank's
    batch against mcm_ref (`rank_stage_check`)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    ref = _to_cpu(train_once(net, params, state, vel, data))
    per_fwd = mcm_launches_per_forward(net)
    t0 = time.perf_counter()
    ranks = _start_ranks(_dp_rank, DP_RANKS)
    wall = time.perf_counter() - t0
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("dp_train", ranks[0]["one"], ref, zero)
    rows = [r["one"]["rows"] for r in ranks]
    check(rows == [[i * TRAIN_BATCH // DP_RANKS,
                    (i + 1) * TRAIN_BATCH // DP_RANKS]
                   for i in range(DP_RANKS)], "dp_train: rows %s" % rows)
    same = [torch.equal(a, b) for r in ranks[1:] for a, b in zip(
        _leaves_only(r["one"]["params"]), _leaves_only(
            ranks[0]["one"]["params"]))]
    check(all(same), "dp_train: the ranks' params differ after the step")
    for r in ranks:
        check(tuple(r["one"]["launches"]) == (per_fwd, per_fwd)
              and r["launches"] == per_fwd * r["steps"],
              "dp_train rank %d: launches %s, %d in %d steps; expected %d "
              "a forward" % (r["rank"], r["one"]["launches"],
                             r["launches"], r["steps"], per_fwd))
    n_steps = DP_WINDOWS[1]
    values = [TRAIN_BATCH * n_steps / w for w in ranks[0]["window_s"]]
    value = statistics.median(values)
    return {"ranks": DP_RANKS, "backend": ranks[0]["backend"],
            "batch": TRAIN_BATCH, "rows_per_rank": TRAIN_BATCH // DP_RANKS,
            "precision": "fp32", "loss": ranks[0]["one"]["loss"],
            "loss_single": ref["loss"], "loss_rel_err": loss_err,
            "errors": errs, "tolerances": TRAIN_TOL,
            "launches_per_forward": per_fwd,
            "launches": [r["launches"] for r in ranks],
            "steps": ranks[0]["steps"], "value": value,
            "unit": "img/s over the global batch, median of windows",
            "window_values": values,
            "single_value": single_fp32["value"],
            "vs_single": value / single_fp32["value"],
            "all_reduces_per_step": [r["all_reduces"] / r["steps"]
                                     for r in ranks],
            "all_reduce_host_ms_per_step": [
                1e3 * r["all_reduce_host_s"] / r["steps"] for r in ranks],
            "step_ms": [1e3 * sum(r["window_s"]) / r["steps"]
                        for r in ranks],
            "ranks_wall_s": wall,
            "kernel_at_rank_batch": rank_stage_check(
                device, TRAIN_BATCH // DP_RANKS, "dp_train")}


def _leaves_only(tree):
    from mpnn_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def dp_nccl_phase(device):
    """dp_nccl: this process alone as a world of one rank over NCCL. The
    mesh `make_mesh` makes there has a 'data' axis of one rank, which
    reduces nothing; one step on an axis over the NCCL world (`world_axis`)
    runs the data-parallel step's all-reduces through NCCL: that step
    against the meshless kernel step at the step gates, and whether the
    two are equal bit for bit (the mesh's moments are sums over the
    count, the meshless means)."""
    import torch.distributed as dist
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.parallel import make_mesh, multihost
    from mpnn_tpu_torch.parallel.mesh import Axis, Mesh, world_axis
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    ref = train_once(net, params, state, vel, data)
    multihost.initialize("127.0.0.1:%d" % multihost.free_port(), 1, 0,
                         timeout_s=JOIN_TIMEOUT_S)
    try:
        backend = dist.get_backend()
        check(backend == "nccl", "dp_nccl: backend %s" % backend)
        check(not make_mesh().data.reduces, "dp_nccl: a one-rank 'data' "
              "axis reduces")
        mesh = Mesh(("data", "model"), [world_axis(), Axis(1, 0)])
        with _counting_all_reduce() as counts:
            got = train_once(net, params, state, vel, data, mesh=mesh)
    finally:
        multihost.shutdown()
    per_fwd = mcm_launches_per_forward(net)
    check(tuple(got["launches"]) == (per_fwd, per_fwd), "dp_nccl: launches %s"
          % (got["launches"],))
    check(counts["calls"] > 0, "dp_nccl: no all-reduce ran")
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("dp_nccl", got, ref, zero)
    bit = {name: all(torch.equal(a, b) for a, b in zip(
        _leaves_only(got[key]), _leaves_only(ref[key])))
        for name, key in (("params", "params"), ("state", "state"),
                          ("grads", "grads"))}
    bit["loss"] = got["loss"] == ref["loss"]
    return {"backend": backend, "world": 1, "batch": TRAIN_BATCH,
            "all_reduces": counts["calls"], "loss": got["loss"],
            "loss_meshless": ref["loss"], "loss_rel_err": loss_err,
            "errors": errs, "bit_for_bit": bit,
            "launches_per_forward": per_fwd}


TP_SHAPES = ((1, 2), (2, 2))  # the ('data', 'model') meshes of tp_train
TP_MIN_CHAN = 64  # mpnn_tpu's shard_params default: stages 4-7 shard
TP_SHARDED_PER_FORWARD = 6  # stages 4-7: 2 + 2 + 1 + 1 scales
TP_WINDOWS = (2, 4)  # timed windows x steps of tp_train, per mesh


@contextlib.contextmanager
def _recording_launches(entry="_launch"):
    """The arguments (the device aside) of every launch through `entry`,
    the kernel's single-net entry `kernels._launch` or its net axis
    `kernels._launch_nets`, in the list yielded, until the block ends
    (the entry wrapped; its count is `_call`'s as ever). A launch's last
    7 arguments are (B, H, W, Cin, Cprev, Cout, dtype code); on the net
    axis the 7th is the number of nets and the 10th prev's per-net
    stride."""
    from mpnn_tpu_torch.ops import kernels
    calls, inner = [], getattr(kernels, entry)

    def launch(dev, *args):
        calls.append(args)
        return inner(dev, *args)

    with mock.patch.object(kernels, entry, launch):
        yield calls


def expected_tp_launches(net, params, batch):
    """[(launch shape (B, H, W, Cin, Cprev, Cout), sharded)] of one forward
    of the flagship chain with `params` (blocks where sharded): each
    MultiscaleConvMax scale's whole input width and the whole width of
    the scale before, its output width, and whether that is a block."""
    from mpnn_tpu_torch.ops import layers as L
    out = []

    def node(n, p):
        for c, pc in zip(n.comps, p["layer"]["comps"]):
            if isinstance(c, L.MultiscaleConvMax):
                for j, (h, w, cin) in enumerate(c._in_shapes):
                    cout = pc["w_horz_%d" % j].shape[-1]
                    cprev = c.hypers.n_chan[j - 1] if j else 0
                    out.append(((batch, h, w, cin, cprev, cout),
                                cout != c.hypers.n_chan[j]))
        for s, ps in zip(n.sinks, p["sinks"]):
            node(s, ps)

    node(net.root, params)
    return out


def _tp_run(net, trees, data, mesh, shape):
    """One mesh's part of a tp_train rank: params and velocity sharded by
    `shard_params(model_parallel=True, min_chan=TP_MIN_CHAN)`, one step
    (`train_once`, its gradients and params gathered whole), the launch
    shapes of a forward, and the timed windows (`make_train_loop`, its
    launches counted from 0, the collectives counted by group)."""
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_loop
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.parallel.mesh import shard_params, unshard_params
    from mpnn_tpu_torch.utils.tree import tree_leaves, tree_paths
    params, state, vel = trees

    def sharded():
        return (shard_params(params, mesh, True, TP_MIN_CHAN), state,
                shard_params(vel, mesh, True, TP_MIN_CHAN))

    p, s, v = sharded()
    blocks = [path for path, a, b in zip(
        tree_paths(p), tree_leaves(p), tree_leaves(params))
        if a.shape != b.shape]
    with _recording_launches() as calls:
        one = train_once(net, p, s, v, data, mesh=mesh)
    one["launch_shapes"] = [a[-7:-1] for a in calls[:one["launches"][0]]]
    one["expected_shapes"] = expected_tp_launches(net, p,
                                                  TRAIN_BATCH // shape[0])
    for key in ("grads", "params"):
        one[key] = unshard_params(one[key], mesh, params)
    loop = make_train_loop(net, TRAIN_BATCH, Schedules(lr=λ_lrn, tau=τ_ds),
                           mesh=mesh)
    trees = loop(*sharded(), 0, 1, *data, 1)[:3]  # warm-up
    n_windows, n_steps = TP_WINDOWS
    t, windows = 1, []
    groups = {"model": mesh.model.group, "data": mesh.data.group}
    with _counting_all_reduce(groups) as counts:
        fused_mcm.launches = 0  # the main path, counted from 0
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trees = loop(*trees, t, 1, *data, n_steps)[:3]
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
            t += n_steps
    return {"coords": (mesh.data.index, mesh.model.index),
            "sharded_leaves": blocks, "one": _to_cpu(one),
            "launches": fused_mcm.launches, "steps": n_windows * n_steps,
            "collectives": counts, "window_s": windows}


def _tp_tree_run(mesh, device):
    """The fresh actor tree with stacked tails on a rank of the 1x2 mesh,
    params and velocity sharded at TP_MIN_CHAN (stages 4-7, the tails'
    among them, whose stacked scales launch on the kernel's net axis):
    one step (`train_once`, its gradients and params gathered whole), and
    the net-axis launches of its forward that write a block of Cout from
    a per-net, gathered prev twice as wide (stage 4-5's scale 1 through
    `fused_mcm_scale` under vmap)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.parallel.mesh import shard_params, unshard_params
    net, params, state, vel = train_bench.build(0, device, arch="tree")
    data = train_bench.train_data(net, device)
    p, v = (shard_params(t, mesh, True, TP_MIN_CHAN) for t in (params, vel))
    config.set_stacked_tails(True)
    try:
        with _recording_launches("_launch_nets") as calls:
            one = train_once(net, p, state, v, data, mesh=mesh)
    finally:
        config.set_stacked_tails(False)
    one["ext_net_launches"] = sum(
        1 for a in calls[:one["net_launches"][0]]
        if a[9] and a[-3] == 2 * a[-2])
    for key in ("grads", "params"):
        one[key] = unshard_params(one[key], mesh, params)
    return _to_cpu(one)


def _tp_rank(rank, n_ranks, port, out_dir):
    """One of tp_train's 4 ranks: the flagship at batch TRAIN_BATCH over
    the 1x2 mesh of ranks 0 and 1 (ranks 2 and 3 wait), with the stacked
    tree's step there (`_tp_tree_run`), then over the 2x2 mesh of all 4
    (`_tp_run`), written to out_dir/rank<r>.pt for the parent."""
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from mpnn_tpu_torch import set_deterministic, train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.parallel import make_mesh, multihost
    from mpnn_tpu_torch.parallel.mesh import Axis, Mesh
    set_deterministic(True)  # the step over 'model' requires it
    multihost.initialize("127.0.0.1:%d" % port, n_ranks, rank,
                         timeout_s=JOIN_TIMEOUT_S)
    try:
        import torch.distributed as dist
        device = multihost.local_device()
        config.set_compute_dtype(None)
        net, params, state, vel = train_bench.build(0, device)
        data = train_bench.train_data(net, device)
        pair = dist.new_group([0, 1])  # every rank makes every group
        meshes = {(1, 2): Mesh(("data", "model"),
                               [Axis(1, 0), Axis(2, rank % 2, pair)]),
                  (2, 2): make_mesh(2, 2)}
        rec = {"rank": rank, "backend": dist.get_backend(),
               "device": str(device)}
        for shape in TP_SHAPES:
            if rank < math.prod(shape):
                rec["%dx%d" % shape] = _tp_run(
                    net, (params, state, vel), data, meshes[shape], shape)
                if shape == (1, 2):
                    rec["1x2"]["tree_stacked"] = _tp_tree_run(
                        meshes[shape], device)
            multihost.sync_global_devices("tp_train %dx%d" % shape)
    finally:
        multihost.shutdown()
    torch.save(rec, os.path.join(out_dir, "rank%d.pt" % rank))


def tp_kernel_rows(device, batch, n_model=2):
    """The kernel's launches at the shapes a rank of the 'model' axis
    gives it (`kernel_bench.sharded_scales`: stages 4-7 at batch `batch`,
    rank 0's blocks), fp32: each against the block of the whole stage's
    mcm_ref output (TOL) and float64 (F64_TOL), timed against mcm_ref and
    the cuDNN sequence, beside its bound."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import (bound, device_ms, scale_cost,
                                             scale_fns, sharded_scales,
                                             stage_inputs, time_ms)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm_scale, mcm_ref
    config.set_compute_dtype(None)
    rows = []
    stages = stage_inputs(arch, batch, 32, seed=7, device=device, first=4)
    for x, wh, b, prev, wv, want, n_ops in sharded_scales(stages, n_model):
        got = fused_mcm_scale(x, wh, b, prev, wv)
        ref = mcm_ref([x], [wh], [] if wv is None else [wv], [b],
                      prev=prev)[0]
        f64 = mcm_ref([x.double()], [wh.double()],
                      [] if wv is None else [wv.double()], [b.double()],
                      prev=None if prev is None else prev.double())[0]
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        err_block = float((got - want).abs().max())
        rel64 = float((got.double() - f64).abs().max()) / float(
            f64.abs().max())
        label = "tp kernel B=%d H=%d Cin=%d Cprev=%d Cout=%d" % (
            batch, x.shape[1], x.shape[-1],
            0 if prev is None else prev.shape[-1], wh.shape[-1])
        check(err <= TOL["fp32"] * scale and err_block <= TOL["fp32"] * scale,
              "%s: max abs err %g (vs the whole stage's block %g) > %g * "
              "max|ref| %g" % (label, err, err_block, TOL["fp32"], scale))
        check(rel64 <= F64_TOL, "%s: %g x max|ref| off float64 > %g"
              % (label, rel64, F64_TOL))
        fns = scale_fns(x, wh, b, prev, wv)
        n_bytes, flops = scale_cost(x, wh, b, prev, wv, n_ops, "fp32")
        bound_ms, bound_by = bound(n_bytes, flops, "fp32")
        row = {"batch": batch, "H": x.shape[1], "Cin": x.shape[-1],
               "Cprev": 0 if prev is None else prev.shape[-1],
               "Cout": wh.shape[-1], "max_abs_err": err,
               "max_abs_err_vs_whole_block": err_block,
               "rel_err_vs_f64": rel64, "bytes": n_bytes, "flops": flops,
               "bound_ms": bound_ms, "bound_by": bound_by.split()[0]}
        for name, fn in fns.items():
            row[name + "ms"] = time_ms(fn)
            row[name + "device_ms"] = device_ms(fn)
        rows.append(row)
    return rows


TP_NETS = 8  # nets of tp_net_axis_rows, as many as a tree's stacked tails


def tp_net_axis_rows(device, batch, n_model=2, n_nets=TP_NETS):
    """The sharded launch shapes on the kernel's net axis, as stacked
    tails under the 'model' axis make them: `torch.func.vmap` of
    `fused_mcm_scale` over n_nets nets, each with its own x, weight
    blocks, bias block and whole prev of the scale before, one net-axis
    launch a call; each net's output against mcm_ref (TOL) and float64
    (F64_TOL), fp32; the call timed against mcm_ref net after net and
    under the same vmap (cuDNN's grouped convs), beside its bound."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import (bound, scale_cost,
                                             sharded_scales, stage_inputs,
                                             time_ms)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, fused_mcm_scale, mcm_ref
    config.set_compute_dtype(None)
    gen = torch.Generator(device=device).manual_seed(13)

    def nets(t):
        noise = torch.randn((n_nets,) + tuple(t.shape), generator=gen,
                            device=t.device)
        return t + 0.1 * float(t.abs().max()) * noise

    def one(x, wh, b, prev=None, wv=None):
        return mcm_ref([x], [wh], [] if wv is None else [wv], [b],
                       prev=prev)[0]

    rows = []
    stages = stage_inputs(arch, batch, 32, seed=11, device=device, first=4)
    for scale in sharded_scales(stages, n_model):
        args = [nets(t) for t in scale[:5] if t is not None]
        call = torch.func.vmap(fused_mcm_scale)
        n0, m0 = fused_mcm.launches, fused_mcm.net_launches
        got = call(*args)
        torch.cuda.synchronize()
        launched = (fused_mcm.launches - n0, fused_mcm.net_launches - m0)
        x, wh = args[:2]
        prev = args[3] if len(args) > 3 else None
        label = "tp net axis %d nets B=%d H=%d Cprev=%d Cout=%d" % (
            n_nets, batch, x.shape[2], 0 if prev is None else prev.shape[-1],
            wh.shape[-1])
        check(launched == (1, 1), "%s: launches %s, expected one on the net "
              "axis" % (label, launched))

        def plain():
            return [one(*[t[i] for t in args]) for i in range(n_nets)]

        err = rel = rel64 = 0.0
        for i, ref in enumerate(plain()):
            f64 = one(*[t[i].double() for t in args])
            scale_i = float(ref.abs().max())
            e = float((got[i] - ref).abs().max())
            check(e <= TOL["fp32"] * scale_i, "%s net %d: max abs err %g > "
                  "%g * max|ref| %g" % (label, i, e, TOL["fp32"], scale_i))
            r64 = float((got[i].double() - f64).abs().max()) / float(
                f64.abs().max())
            check(r64 <= F64_TOL, "%s net %d: %g x max|ref| off float64 > "
                  "%g" % (label, i, r64, F64_TOL))
            err, rel, rel64 = max(err, e), max(rel, e / scale_i), max(rel64,
                                                                      r64)
        n_bytes, flops = scale_cost(*scale[:5], scale[6], "fp32")
        bound_ms, bound_by = bound(n_nets * n_bytes, n_nets * flops, "fp32")
        library = torch.func.vmap(one)
        rows.append({"nets": n_nets, "batch": batch, "H": x.shape[2],
                     "Cin": x.shape[-1],
                     "Cprev": 0 if prev is None else prev.shape[-1],
                     "Cout": wh.shape[-1], "max_abs_err": err,
                     "max_rel_err": rel, "rel_err_vs_f64": rel64,
                     "ms": time_ms(lambda: call(*args)),
                     "plain_ms": time_ms(plain),
                     "library_ms": time_ms(lambda: library(*args)),
                     "bound_ms": bound_ms, "bound_by": bound_by.split()[0]})
    return rows


def tp_train_phase(device):
    """tp_train: the flagship actor chain at k_cpts[4], fp32, global batch
    TRAIN_BATCH, over a 1x2 and a 2x2 ('data', 'model') mesh of ranks
    sharing the card over gloo (`_tp_rank`: one start of 4 ranks), params
    and velocity sharded by
    `shard_params(model_parallel=True, min_chan=64)` (the 8 weight
    leaves of stages 4-7; the 16-wide routers and 10-class leaves
    whole): one step against the single-process kernel step at the step
    gates, every rank's whole params equal after it, 20 launches a
    forward on each rank, 6 of them at sharded shapes (the launch shapes
    of a forward as expected, counted in each rank's process); then
    TP_WINDOWS timed windows: img/s over the global batch, each rank's
    launches counted from 0 against 20 x steps, and the collectives a
    step over 'model' and 'data' with their host time. The sharded
    launch shapes at a rank's batch (128 on 1x2, 64 on 2x2) against
    mcm_ref and float64, timed (`tp_kernel_rows`). On 1x2 also the actor
    tree with stacked tails (`_tp_tree_run`): one step against the
    single-process stacked step at the step gates, the ranks' whole
    params equal, its launches a forward as the meshless stacked tree's
    (33, 9 on the net axis), some of them net-axis launches from a
    per-net prev; and the sharded shapes on the net axis against mcm_ref
    and float64 (`tp_net_axis_rows`)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    ref = _to_cpu(train_once(net, params, state, vel, data))
    per_fwd = mcm_launches_per_forward(net)
    zero = zero_grad_paths(net)
    tnet, tparams, tstate, tvel = train_bench.build(0, device, arch="tree")
    config.set_stacked_tails(True)
    try:
        tree_ref = _to_cpu(train_once(tnet, tparams, tstate, tvel,
                                      train_bench.train_data(tnet, device)))
    finally:
        config.set_stacked_tails(False)
    tree_zero = zero_grad_paths(tnet)
    del tparams, tstate, tvel
    meshes, kernel_rows = {}, {}
    t0 = time.perf_counter()
    started = _start_ranks(_tp_rank, 4)
    wall = time.perf_counter() - t0
    for shape in TP_SHAPES:
        n_ranks = math.prod(shape)
        name = "%dx%d" % shape
        ranks = [dict(r[name], rank=r["rank"], backend=r["backend"])
                 for r in started[:n_ranks]]
        label = "tp_train %s" % name
        loss_err, errs = step_gates(label, ranks[0]["one"], ref, zero)
        for r in ranks:
            check(len(r["sharded_leaves"]) == 8, "%s rank %d: %d sharded "
                  "leaves, expected 8" % (label, r["rank"],
                                          len(r["sharded_leaves"])))
            one = r["one"]
            same = [torch.equal(a, b) for a, b in zip(
                _leaves_only(one["params"]),
                _leaves_only(ranks[0]["one"]["params"]))]
            check(all(same), "%s: rank %d's whole params differ from rank "
                  "0's after the step" % (label, r["rank"]))
            got = sorted(map(tuple, one["launch_shapes"]))
            want = sorted(tuple(sh) for sh, _ in one["expected_shapes"])
            r["sharded_per_forward"] = sum(
                sharded for _, sharded in one["expected_shapes"])
            check(tuple(one["launches"]) == (per_fwd, per_fwd)
                  and got == want
                  and r["sharded_per_forward"] == TP_SHARDED_PER_FORWARD
                  and r["launches"] == per_fwd * r["steps"],
                  "%s rank %d: launches %s (shapes %s, expected %s; %d "
                  "sharded), %d in %d steps; expected %d a forward, %d "
                  "sharded" % (label, r["rank"], one["launches"], got,
                               want, r["sharded_per_forward"],
                               r["launches"], r["steps"], per_fwd,
                               TP_SHARDED_PER_FORWARD))
        n_steps = TP_WINDOWS[1]
        values = [TRAIN_BATCH * n_steps / w for w in ranks[0]["window_s"]]
        by_group = {g: {"per_step": [r["collectives"]["by_group"][g][0]
                                     / r["steps"] for r in ranks],
                        "host_ms_per_step": [
                            1e3 * r["collectives"]["by_group"][g][1]
                            / r["steps"] for r in ranks]}
                    for g in ("model", "data")}
        meshes[name] = {
            "ranks": n_ranks, "backend": ranks[0]["backend"],
            "rows_per_rank": TRAIN_BATCH // shape[0],
            "sharded_leaves": ranks[0]["sharded_leaves"],
            "loss": ranks[0]["one"]["loss"], "loss_single": ref["loss"],
            "loss_rel_err": loss_err, "errors": errs,
            "launches": [r["launches"] for r in ranks],
            "steps": ranks[0]["steps"],
            "sharded_launches_per_forward": [r["sharded_per_forward"]
                                             for r in ranks],
            "value": statistics.median(values),
            "unit": "img/s over the global batch, median of windows",
            "window_values": values,
            "collectives": by_group,
            "step_ms": [1e3 * sum(r["window_s"]) / r["steps"]
                        for r in ranks]}
        if "tree_stacked" in ranks[0]:
            meshes[name]["tree_stacked"] = tp_tree_gates(
                label, [r["tree_stacked"] for r in ranks], tree_ref,
                tree_zero)
        kernel_rows[name] = tp_kernel_rows(device, TRAIN_BATCH // shape[0])
    return {"batch": TRAIN_BATCH, "precision": "fp32",
            "min_chan": TP_MIN_CHAN, "tolerances": TRAIN_TOL,
            "launches_per_forward": per_fwd, "meshes": meshes,
            "ranks_wall_s": wall,
            "kernel_at_rank_batch": kernel_rows,
            "net_axis_at_rank_batch": tp_net_axis_rows(device, TRAIN_BATCH)}


def tp_tree_gates(label, trees, ref, zero):
    """The stacked tree's step on each rank of a mesh (`_tp_tree_run`)
    against the single-process stacked step `ref`: the step gates, the
    ranks' whole params equal, STACKED_PER_FORWARD's launches and some
    net-axis launches from a per-net prev."""
    label += " tree stacked"
    loss_err, errs = step_gates(label, trees[0], ref, zero)
    n, m = STACKED_PER_FORWARD["tree"]
    for i, t in enumerate(trees):
        same = [torch.equal(a, b) for a, b in zip(
            _leaves_only(t["params"]), _leaves_only(trees[0]["params"]))]
        check(all(same), "%s: rank %d's whole params differ from rank 0's "
              "after the step" % (label, i))
        check(tuple(t["launches"]) == (n, n)
              and tuple(t["net_launches"]) == (m, m)
              and t["ext_net_launches"] > 0,
              "%s rank %d: launches %s (net axis %s, %d from a per-net "
              "prev); expected %d (%d) a forward, some from a per-net prev"
              % (label, i, t["launches"], t["net_launches"],
                 t["ext_net_launches"], n, m))
    return {"loss": trees[0]["loss"], "loss_single": ref["loss"],
            "loss_rel_err": loss_err, "errors": errs,
            "launches_per_forward": n, "net_launches_per_forward": m,
            "ext_net_launches_per_forward": [t["ext_net_launches"]
                                             for t in trees]}


def tp_summary(rows_by_mesh):
    """Per mesh: the sharded launches' summed times (kernel, mcm_ref, the
    cuDNN sequence; call and device) and bound, the worst errors."""
    out = {}
    for name, rows in rows_by_mesh.items():
        tot = {k: sum(r[k] for r in rows) for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms",
            "cudnn_conv_sequence_ms", "cudnn_conv_sequence_device_ms",
            "bound_ms")}
        tot.update(batch=rows[0]["batch"], n_launches=len(rows),
                   max_abs_err=max(r["max_abs_err"] for r in rows),
                   max_rel_err_vs_f64=max(r["rel_err_vs_f64"]
                                          for r in rows))
        out[name] = tot
    return out


def start_dryrun(out_path):
    """`python -m mpnn_tpu_torch.dryrun 4` (4 ranks on the card over gloo;
    phase 1 on mpnn_tpu's 2x2 dp x tp mesh) in a session of its own, its
    output to out_path: the process. The smoke starts it beside the
    phases of 7f, which time nothing, reads it in `dryrun_phase` before
    any timed phase and stops what is left of it with `stop_dryrun`."""
    import subprocess
    with open(out_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "mpnn_tpu_torch.dryrun", "4"], cwd=HERE,
            stdout=out, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)


def stop_dryrun(proc):
    """Kill the dry run's session (the process and the ranks it spawned),
    whether or not it has ended."""
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def dryrun_phase(proc, out_path):
    """dryrun: the run `start_dryrun` started, its OK lines (phase 1 on
    the 2x2 mesh, on the card) and its seconds."""
    rc = proc.wait(timeout=MESH_TIMEOUT_S)
    with open(out_path) as f:
        text = f.read()
    check(rc == 0, "dryrun: exit %d\n%s" % (rc, text[-3000:]))
    lines = [x for x in text.splitlines()
             if x.startswith("dryrun_multichip(4)")]
    check(len(lines) == 3 and "mesh={'data': 2, 'model': 2}" in lines[0]
          and lines[0].endswith(" OK") and lines[1].endswith(" OK")
          and " on cuda " in lines[2], "dryrun: %r" % lines)
    return {"lines": lines}


def _desc_leaves(desc, path=""):
    """{path: float64 array} of every numeric leaf of a descriptor."""
    if isinstance(desc, dict):
        return {k: v for key in sorted(desc) for k, v in
                _desc_leaves(desc[key], "%s/%s" % (path, key)).items()}
    if isinstance(desc, list):
        return {k: v for i, d in enumerate(desc)
                for k, v in _desc_leaves(d, "%s[%d]" % (path, i)).items()}
    if isinstance(desc, str):
        return {}
    return {path: np.asarray(desc, np.float64)}


def _files_of(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def compare_net_files(label, got_root, want_root, i, zero, n_evals,
                      vel_tol=TRAIN_TOL):
    """Net i's files in got_root against want_root's: the same names; its
    checkpoint's params at the step gates (tree, leaf and zero-gradient
    leaves of TRAIN_TOL), its velocity at vel_tol's (after one step from
    zero, the gradient after TALR), its BatchNorm statistics per leaf,
    its latest descriptors within DESC_TOL x max(1, |stat|), and its log
    written once per evaluation. Returns the errors."""
    from mpnn_tpu_torch.utils.serdes import read_net
    _, gp, gs, gx = read_net(os.path.join(got_root, "%.4i.npy" % i), "cpu")
    _, wp, ws, wx = read_net(os.path.join(want_root, "%.4i.npy" % i), "cpu")
    check(gx["t"] == wx["t"], "%s net %d: step %s, expected %s"
          % (label, i, gx["t"], wx["t"]))
    errs = {"parameter": tree_errs(gp, wp, zero),
            "velocity": tree_errs(gx["vel"], wx["vel"], zero),
            "BatchNorm statistic": tree_errs(gs, ws)}
    check(errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "%s net %d: BatchNorm statistic error %g" % (
              label, i, errs["BatchNorm statistic"]["leaf"]))
    for name, tol in (("parameter", TRAIN_TOL), ("velocity", vel_tol)):
        for key in ("tree", "leaf", "zero_grad"):
            check(errs[name][key] <= tol[key], "%s net %d: %s %s error "
                  "%g > %g (worst leaf %s)" % (
                      label, i, name, key, errs[name][key], tol[key],
                      errs[name]["worst_leaf"]))
    load = lambda root: np.load(  # noqa: E731
        os.path.join(root, "%.4i-stats.npy" % i), allow_pickle=True)[()]
    got, want = _desc_leaves(load(got_root)), _desc_leaves(load(want_root))
    check(sorted(got) == sorted(want), "%s net %d: descriptor keys differ"
          % (label, i))
    desc_err = max(float(np.max(np.abs(got[k] - v) / np.maximum(
        1.0, np.abs(v)))) for k, v in want.items())
    check(desc_err <= DESC_TOL, "%s net %d: descriptors differ by %g"
          % (label, i, desc_err))
    with open(os.path.join(got_root, "%.4i-log.txt" % i)) as f:
        n_logged = f.read().count("Epoch")
    check(n_logged == n_evals, "%s net %d: %d evaluations logged, "
          "expected %d (each written once)" % (label, i, n_logged, n_evals))
    return {"parameter_tree": errs["parameter"]["tree"],
            "parameter_leaf": errs["parameter"]["leaf"],
            "velocity_tree": errs["velocity"]["tree"],
            "velocity_leaf": errs["velocity"]["leaf"],
            "velocity_zero_grad": errs["velocity"]["zero_grad"],
            "state_leaf": errs["BatchNorm statistic"]["leaf"],
            "desc": desc_err}


def _start_cli(argv, out_path, launcher=()):
    """A CLI run over ranks in processes of its own (the CLI's own ranks,
    or a launcher's), its output to out_path: the process."""
    import subprocess
    with open(out_path, "w") as out:
        return subprocess.Popen([sys.executable, *launcher, "-m",
                                 "mpnn_tpu_torch.train", *argv], cwd=HERE,
                                stdout=out, stderr=subprocess.STDOUT,
                                text=True)


def _finish_cli(proc, out_path, label):
    """Wait for a `_start_cli` run: its output and each rank's closing
    JSON line, in rank order; a failed or overdue run fails the phase."""
    import subprocess
    try:
        rc = proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    with open(out_path) as f:
        text = f.read()
    check(rc == 0, "%s: exit %d\n%s" % (label, rc, text[-3000:]))
    ranks = sorted((json.loads(line) for line in text.splitlines()
                    if line.startswith('{"rank"')), key=lambda x: x["rank"])
    return text, ranks


def _mesh_data(d):
    """The small synthetic synth.npz of the registry's synth-* runs."""
    from mpnn_tpu_torch.data.prep import save_archive, synthetic_archive
    save_archive(os.path.join(d, "data", "synth.npz"),
                 synthetic_archive("synth.npz", small=True))


def _eval_batches(d):
    from mpnn_tpu_torch.data.dataset import Dataset
    ds = Dataset(os.path.join(d, "data", "synth.npz"), device_put=False)
    return sum(-(-len(x) // TRAIN_BATCH) for x in (ds.x0_tr, ds.x0_ts))


def start_mesh_clis(d):
    """sweep_mesh's and mesh_cli's CLI runs (`mesh_cli_phases`) in
    processes of their own, their data and output in d: (processes,
    output paths, start time). The smoke starts them in phase 7f, beside
    phases that time nothing, and checks them after dp_nccl."""
    from mpnn_tpu_torch.parallel.multihost import free_port
    _mesh_data(d)
    common = ["--n-iter", str(MESH_CLI_STEPS), "--t-log", str(CLI_T_LOG),
              "--batch-size", str(TRAIN_BATCH)]
    out = {k: os.path.join(d, k + ".out") for k in ("sweep", "cli")}
    t0 = time.perf_counter()
    procs = {"sweep": _start_cli(
        ["synth-ac", "--vmap-sweep", "--mesh", "%dx1" % DP_RANKS,
         "--data-root", d, "--out-root", os.path.join(d, "mesh"), *common],
        out["sweep"])}
    try:
        procs["cli"] = _start_cli(
            ["synth-ac", "--net", "4", "--multihost", "--mesh", "auto",
             "--data-root", d, "--out-root", os.path.join(d, "torchrun"),
             *common], out["cli"],
            launcher=("-m", "torch.distributed.run", "--nproc-per-node",
                      str(DP_RANKS), "--master-addr", "127.0.0.1",
                      "--master-port", str(free_port())))
    except BaseException:
        procs["sweep"].kill()
        raise
    return procs, out, t0


def _kill(started):
    """Kill what is still running of `start_mesh_clis`'s processes."""
    for p in (started or ({},))[0].values():
        if p.poll() is None:
            p.kill()


def mesh_cli_phases(device, d, started):
    """sweep_mesh and mesh_cli, the CLI over ranks in processes of its own,
    both started at once by `start_mesh_clis` in d, MESH_CLI_STEPS steps
    at batch TRAIN_BATCH, fp32, on the small synthetic archive, each
    against the same run in this process:

    - sweep_mesh: `train synth-ac --vmap-sweep --mesh 2x1` (the CLI starts
      2 ranks on the card, 4 nets each, no collective between nets)
      against the meshless sweep; every member's files
      (`compare_net_files`, the velocity at SWEEP_MESH_VEL_TOL), the
      meshless sweep's own velocity gaps (`sweep_width_gap`), each rank's
      net-axis launches counted from 0
      in its process against PER_FORWARD x (steps + evaluation batches);
      the net axis at 4 nets against mcm_ref (`net_axis_rows`, untimed).
    - mesh_cli: `python -m torch.distributed.run --nproc-per-node 2 -m
      mpnn_tpu_torch.train synth-ac --net 4 --multihost --mesh auto` (two
      ranks on the card over gloo, data-parallel at a global batch of
      TRAIN_BATCH) against `train synth-ac --net 4`: the files (rank 0
      alone writes) and each rank's launches against PER_FORWARD x
      (steps + evaluation batches: each rank evaluates its rows of every
      batch).

    Returns the two phases' records."""
    import contextlib
    import io
    from mpnn_tpu_torch import train as cli
    from mpnn_tpu_torch.experiments import arch, make_experiments
    from mpnn_tpu_torch.kernel_bench import sweep_stage_inputs
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    config.set_compute_dtype(None)
    n_per_rank = N_NETS // DP_RANKS
    steps = MESH_CLI_STEPS
    registry = make_experiments()
    procs, out, t0 = started
    n_batches = _eval_batches(d)
    try:
        n0, m0 = fused_mcm.launches, fused_mcm.net_launches
        with contextlib.redirect_stdout(io.StringIO()):
            cli.train_experiment(
                "synth-ac", n_iter=steps, t_log=CLI_T_LOG,
                batch_size=TRAIN_BATCH, data_root=d,
                out_root=os.path.join(d, "meshless"), device=device,
                vmap_sweep=True)
            meshless_launches = fused_mcm.net_launches - m0
            n1 = fused_mcm.launches
            cli.train_experiment(
                "synth-ac", n_iter=steps, t_log=CLI_T_LOG,
                batch_size=TRAIN_BATCH, net_indices=[4], data_root=d,
                out_root=os.path.join(d, "single"), device=device)
            single_launches = fused_mcm.launches - n1
        check(n1 - n0 == meshless_launches, "sweep_mesh: the meshless "
              "sweep launched off the net axis")
        width = sweep_width_gap(device)
        _, sweep_ranks = _finish_cli(procs["sweep"], out["sweep"],
                                     "sweep_mesh")
        text, cli_ranks = _finish_cli(procs["cli"], out["cli"],
                                      "mesh_cli")
    finally:
        _kill(started)
    wall = time.perf_counter() - t0
    # One evaluation, at the end (steps < CLI_T_LOG).
    net = registry["synth-ac"].nets[4]((32, 32, 3), (10,))
    per_fwd = mcm_launches_per_forward(net)
    expect = per_fwd * (steps + n_batches)
    zero = zero_grad_paths(net)

    check([r["rank"] for r in sweep_ranks] == list(range(DP_RANKS))
          and all(r["mesh"] == {"sweep": DP_RANKS, "data": 1}
                  and r["fused_mcm_net_launches"] == expect
                  == r["fused_mcm_launches"] for r in sweep_ranks)
          and meshless_launches == expect,
          "sweep_mesh: ranks %s, meshless %d net-axis launches; "
          "expected %d each" % (sweep_ranks, meshless_launches, expect))
    got = os.path.join(d, "mesh", "synth-ac")
    want = os.path.join(d, "meshless", "synth-ac")
    check(_files_of(got) == _files_of(want), "sweep_mesh: files %s vs "
          "%s" % (_files_of(got), _files_of(want)))
    members = [compare_net_files("sweep_mesh", got, want, i, zero, 1,
                                 SWEEP_MESH_VEL_TOL)
               for i in range(N_NETS)]

    check([r["rank"] for r in cli_ranks] == list(range(DP_RANKS))
          and all(r["mesh"] == {"data": DP_RANKS, "model": 1}
                  and r["fused_mcm_launches"] == expect
                  for r in cli_ranks) and single_launches == expect,
          "mesh_cli: ranks %s, single %d launches; expected %d each"
          % (cli_ranks, single_launches, expect))
    check(all("[multihost: rank %d of %d]" % (r, DP_RANKS) in text
              for r in range(DP_RANKS)), "mesh_cli: ranks not joined")
    got = os.path.join(d, "torchrun", "synth-ac")
    want = os.path.join(d, "single", "synth-ac")
    check(_files_of(got) == _files_of(want), "mesh_cli: files %s vs %s"
          % (_files_of(got), _files_of(want)))
    cli_errs = compare_net_files("mesh_cli", got, want, 4, zero, 1)
    rows = net_axis_rows("sweep_mesh", sweep_stage_inputs(
        arch, n_per_rank, TRAIN_BATCH, 32, seed=6, device=device),
        n_per_rank, ("fp32",), timed=False)
    common = {"steps": steps, "batch": TRAIN_BATCH,
              "eval_batches": n_batches, "both_runs_wall_s": wall}
    return ({"mesh": "%dx1" % DP_RANKS, "nets": N_NETS,
             "nets_per_rank": n_per_rank,
             "rank_launches": [{k: r[k] for k in (
                 "rank", "device", "fused_mcm_launches",
                 "fused_mcm_net_launches")} for r in sweep_ranks],
             "meshless_net_launches": meshless_launches,
             "members": members, "velocity_tolerances": SWEEP_MESH_VEL_TOL,
             "meshless_width_gap": width,
             "kernel_net_axis": {
                 "nets": n_per_rank,
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "max_rel_err_vs_f64": max(r["rel_err_vs_f64"]
                                           for r in rows),
                 "bit_equal_to_single_net": all(
                     r["bit_equal_to_single_net"] for r in rows)},
             **common},
            {"launcher": "torch.distributed.run", "ranks": DP_RANKS,
             "rank_launches": [{k: r[k] for k in (
                 "rank", "device", "fused_mcm_launches")}
                 for r in cli_ranks],
             "single_launches": single_launches, "errors": cli_errs,
             **common})


def _grad_and_value_sweep(net, batch):
    """loss_and_grads(params_s, state_s, k_cpts, xb, yb, tau) of the sweep
    by `torch.func.vmap` of `torch.func.grad_and_value` of the member
    loss, the route the port's sweep does not take (it takes
    `torch.autograd.grad` through the vmapped loss): sweep_remat's
    comparison."""
    from mpnn_tpu_torch.models.net import Ctx, _hyper
    from mpnn_tpu_torch.models.steps import _loss_fn
    eps = float(_hyper(net, "ϵ", 1e-6))
    grad_and_loss = torch.func.grad_and_value(_loss_fn(net, batch),
                                              has_aux=True)

    def member(params, state, k_cpt, xb, yb, tau):
        return grad_and_loss(params, state, xb, yb, Ctx(
            train=True, tau=tau, eps=eps, k_cpt=k_cpt))

    return torch.func.vmap(member, in_dims=(0, 0, 0, None, None, None))


def sweep_routes(net, trees, k_cpts, data, zero):
    """The 8-net sweep's loss and gradients, without a remat policy, by
    the port's route (`_sweep_members`) and by `_grad_and_value_sweep`:
    the two held at the step gates, the median of ROUTE_REPS calls of
    each (CUDA events, the two interleaved) and each call's peak device
    memory."""
    from mpnn_tpu_torch.data.augment import augment_presampled, sampled_batch
    from mpnn_tpu_torch.experiments import τ_ds
    from mpnn_tpu_torch.models.steps import _sweep_members
    params, state, _ = trees
    x0, y, m_sym = data
    dev = x0.device
    xb, yb = sampled_batch(torch.Generator(dev).manual_seed(0), x0, y,
                           TRAIN_BATCH)
    xa, ya = augment_presampled(torch.Generator(dev).manual_seed(1), xb, yb,
                                m_sym)
    args = (params, state, k_cpts, xa, ya, τ_ds(0))
    routes = {"autograd": _sweep_members(net, TRAIN_BATCH)[0],
              "grad_and_value": _grad_and_value_sweep(net, TRAIN_BATCH)}
    out, grads = {}, {}
    for name, fn in routes.items():
        fn(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g, (loss, _) = fn(*args)
        torch.cuda.synchronize()
        out[name] = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
                     "ms": []}
        grads[name] = (g, loss)
    for _ in range(ROUTE_REPS):
        for name, fn in routes.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            out[name]["ms"].append(a.elapsed_time(b))
    for rec in out.values():
        rec["median_ms"] = statistics.median(rec["ms"])
    (g, loss), (g_ref, loss_ref) = grads["autograd"], grads["grad_and_value"]
    loss_err = float(torch.max(torch.abs(loss - loss_ref)
                               / torch.abs(loss_ref)))
    errs = tree_errs(g, g_ref, zero)
    check(loss_err <= TRAIN_TOL["loss"] and all(
        errs[k] <= TRAIN_TOL[k] for k in ("tree", "leaf", "zero_grad")),
        "sweep_remat routes: loss %g, gradient errors %s" % (loss_err, errs))
    return {"routes": out, "loss_rel_err": loss_err, "gradient": errs,
            "autograd_vs_grad_and_value_ms": (
                out["autograd"]["median_ms"]
                / out["grad_and_value"]["median_ms"]),
            "timing": "the loss and gradients alone, CUDA events around "
                      "one call, median of %d" % ROUTE_REPS}


def sweep_remat_phase(device):
    """sweep_remat: one fp32 step of the 8-net flagship sweep under
    remat_policy "full" and "dots" (the gradient through the vmapped
    forward, checkpointed) against the step without a policy, at the step
    gates, with the launches of the loss and gradient ("full" recomputes
    every stage: twice PER_FORWARD; "dots" saves the stage's outputs) and
    the peak device memory of the step; then, without a policy, the
    port's gradient route beside `torch.func.grad_and_value`'s
    (`sweep_routes`)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel, k_cpts = train_bench.build_sweep(N_NETS, 0,
                                                              device)
    data = train_bench.train_data(net, device)
    per_fwd = mcm_launches_per_forward(net)
    zero = zero_grad_paths(net)
    out, ref = {}, None
    try:
        for policy in (None, "full", "dots"):
            config.set_remat(policy)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            rec = sweep_once(net, (params, state, vel), k_cpts, data)
            peak = torch.cuda.max_memory_allocated() - base
            want = 2 * per_fwd if policy == "full" else per_fwd
            check(rec["launches"] == (want, want)
                  and rec["net_launches"] == rec["launches"],
                  "sweep_remat %s: launches %s, expected %d on the net "
                  "axis" % (policy, rec["launches"], want))
            if ref is None:
                ref = rec
                out["none"] = {"peak_bytes": peak,
                               "launches": rec["launches"][0]}
                continue
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                rec["loss"], ref["loss"]))
            errs = {"gradient": tree_errs(rec["grads"], ref["grads"], zero),
                    "parameter": tree_errs(rec["params"], ref["params"],
                                           zero),
                    "BatchNorm statistic": tree_errs(rec["state"],
                                                     ref["state"])}
            check(loss_err <= TRAIN_TOL["loss"]
                  and errs["BatchNorm statistic"]["leaf"]
                  <= TRAIN_TOL["state"]
                  and all(errs[n][k] <= TRAIN_TOL[k]
                          for n in ("gradient", "parameter")
                          for k in ("tree", "leaf", "zero_grad")),
                  "sweep_remat %s: loss %g, errors %s" % (policy, loss_err,
                                                          errs))
            out[policy] = {"loss_rel_err": loss_err, "errors": errs,
                           "peak_bytes": peak,
                           "launches": rec["launches"][0]}
    finally:
        config.set_remat(None)
    return {"nets": N_NETS, "batch": TRAIN_BATCH, "precision": "fp32",
            "launches_per_sweep_forward": per_fwd, "tolerances": TRAIN_TOL,
            "policies": out, "no_policy_routes": sweep_routes(
                net, (params, state, vel), k_cpts, data, zero)}


def sweep_width_gap(device):
    """The meshless 8-net flagship sweep step (fp32, from zero velocity)
    against itself run again, and against the two 4-net steps of its
    halves (members 0-3 and 4-7: a 2x1 sweep mesh's shares, each rank's
    vmap 4 wide): per member, the velocity's errors (tree, leaf) and the
    worst over members. Not gates: the readings behind
    SWEEP_MESH_VEL_TOL."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.tree import tree_map, unstack_tree
    config.set_compute_dtype(None)
    net, params, state, vel, k_cpts = train_bench.build_sweep(N_NETS, 0,
                                                              device)
    data = train_bench.train_data(net, device)
    zero = zero_grad_paths(net)
    trees = (params, state, vel)
    full = sweep_once(net, trees, k_cpts, data)
    again = sweep_once(net, trees, k_cpts, data)
    k = N_NETS // DP_RANKS
    halves = [sweep_once(net, tuple(tree_map(
        lambda a: a[lo:lo + k].clone(), t) for t in trees),
        k_cpts[lo:lo + k], data) for lo in range(0, N_NETS, k)]
    out = {"repeat": [], "width_%d_vs_%d" % (k, N_NETS): []}
    for i in range(N_NETS):
        want = unstack_tree(full["vel"], i)
        for key, got in (("repeat", unstack_tree(again["vel"], i)),
                         ("width_%d_vs_%d" % (k, N_NETS),
                          unstack_tree(halves[i // k]["vel"], i % k))):
            e = tree_errs(got, want, zero)
            out[key].append({"tree": e["tree"], "leaf": e["leaf"]})
    return {key: {"worst_tree": max(r["tree"] for r in rows),
                  "worst_leaf": max(r["leaf"] for r in rows),
                  "members": rows} for key, rows in out.items()}


# C1, the training step's repeat (repeat_phase): the modes, as
# (torch.use_deterministic_algorithms, cudnn.deterministic); each repeat
# runs REPEAT_STEPS steps twice from one state; the rates come from
# REPEAT_WINDOWS windows of REPEAT_TIMED steps per loop and mode, the
# modes in turns; the NaN check's cost from NAN_CHECKS calls.
# A mode is (use_deterministic_algorithms, cudnn.deterministic,
# fill_uninitialized_memory); TIMED_MODES are timed.
DET_MODES = {"default": (False, False, True),
             "cudnn_deterministic": (False, True, True),
             "deterministic": (True, True, True),
             "deterministic_no_fill": (True, True, False)}
TIMED_MODES = ("default", "deterministic")
REPEAT_STEPS = 3
REPEAT_WINDOWS = 2
REPEAT_TIMED = {"serial": 10, "sweep": 5}
NAN_CHECKS = 20


def set_modes(algorithms, cudnn, fill):
    """The determinism switches: `torch.use_deterministic_algorithms`
    (warn_only, as `mpnn_tpu_torch.set_deterministic` sets it, so an op
    without a deterministic form names itself in a warning), whether it
    fills new tensors (NaN), and cuDNN's; autotuning off."""
    torch.use_deterministic_algorithms(algorithms, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = fill
    torch.backends.cudnn.deterministic = cudnn
    torch.backends.cudnn.benchmark = False


def repeat_phase(device):
    """C1: the fp32 flagship's serial loop and the 8-net sweep's loop,
    each run REPEAT_STEPS steps twice from the same state in each of
    DET_MODES: per tree (params, state, velocity) the leaves that differ,
    the first of them, and the worst member's ||a - b|| / ||b||; the
    warnings that name ops without a deterministic form. Then both loops'
    img/s in windows taken in turns, default against deterministic, and
    the cost of `check_nans` (`train --debug-nans`) over a step's trees,
    device time included. Ends in the default mode."""
    import warnings
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, check_nans,
                                             make_sweep_train_loop,
                                             make_train_loop)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.tree import tree_map, unstack_tree
    config.set_compute_dtype(None)
    sched = Schedules(lr=λ_lrn, tau=τ_ds)
    net, *start = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    snet, *sstart, k_cpts = train_bench.build_sweep(N_NETS, 0, device)
    loops = {"serial": (make_train_loop(net, TRAIN_BATCH, sched), start,
                        None, 1),
             "sweep": (make_sweep_train_loop(snet, TRAIN_BATCH, sched),
                       sstart, k_cpts, N_NETS)}
    zero = zero_grad_paths(net)

    def run(name, n, trees=None, t0=0):
        loop, first, k, _ = loops[name]
        trees = [tree_map(torch.clone, x) for x in (trees or first)]
        out = loop(*trees, t0, 0, *data, n, k)
        torch.cuda.synchronize()
        return out

    def gap(name, a, b):
        members = ([lambda x, i=i: unstack_tree(x, i) for i in range(N_NETS)]
                   if name == "sweep" else [lambda x: x])
        rec = {"loss_equal": torch.equal(a[3], b[3])}
        for j, key in enumerate(("params", "state", "velocity")):
            la, lb = _leaves(a[j]), _leaves(b[j])
            differ = ["/".join(map(str, p)) for (p, x), (_, y)
                      in zip(la, lb) if not torch.equal(x, y)]
            z = frozenset() if key == "state" else zero
            rec[key] = {"leaves_differ": len(differ), "leaves": len(la),
                        "first_differ": differ[:3],
                        "worst_tree": max(tree_errs(m(a[j]), m(b[j]), z)[
                            "tree"] for m in members)}
        rec["bit_for_bit"] = rec["loss_equal"] and not any(
            rec[k]["leaves_differ"] for k in ("params", "state", "velocity"))
        return rec

    repeat, nan_ms = {}, {}
    try:
        for mode, flags in DET_MODES.items():
            set_modes(*flags)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rec = {}
                for name in loops:
                    run(name, 1)
                    rec[name] = gap(name, run(name, REPEAT_STEPS),
                                    run(name, REPEAT_STEPS))
            rec["nondeterministic_ops"] = sorted({
                str(w.message)[:200] for w in caught
                if "determinis" in str(w.message)})
            repeat[mode] = rec
        rates = {name: {m: [] for m in TIMED_MODES} for name in loops}
        trees = {name: run(name, 1)[:3] for name in loops}
        for w in range(REPEAT_WINDOWS):
            for mode in TIMED_MODES:
                set_modes(*DET_MODES[mode])
                for name, (loop, _, k, n_nets) in loops.items():
                    n = REPEAT_TIMED[name]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trees[name] = loop(*trees[name], 1 + w * n, 0, *data, n,
                                       k)[:3]
                    torch.cuda.synchronize()
                    rates[name][mode].append(n * n_nets * TRAIN_BATCH
                                             / (time.perf_counter() - t0))
        for name, (params, state, vel) in trees.items():
            # A step's trees: the loss, gradients shaped as the params,
            # the params, state and velocity.
            loss = torch.ones(N_NETS if name == "sweep" else (),
                              device=device)
            times = []
            for _ in range(NAN_CHECKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                check_nans(0, loss=loss, gradients=vel, params=params,
                           state=state, velocity=vel)
                times.append(time.perf_counter() - t0)
            nan_ms[name] = statistics.median(times) * 1e3
    finally:
        set_modes(*DET_MODES["default"])
    timing = {}
    for name, (_, _, _, n_nets) in loops.items():
        med = {m: statistics.median(r) for m, r in rates[name].items()}
        step_ms = n_nets * TRAIN_BATCH * 1e3 / med["default"]
        timing[name] = {
            "img_s": med, "window_img_s": rates[name],
            "cost": {m: 1 - med[m] / med["default"] for m in TIMED_MODES
                     if m != "default"},
            "step_ms": step_ms, "check_nans_ms": nan_ms[name],
            "check_nans_share": nan_ms[name] / step_ms}
    return {"batch": TRAIN_BATCH, "nets": N_NETS, "steps": REPEAT_STEPS,
            "cublas_workspace_config":
                os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "repeat": repeat, "timing": timing}


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import mpnn_tpu_torch  # noqa: F401 -- fails where the port is absent
    from mpnn_tpu_torch.kernel_bench import bound, nvidia_smi
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi)

    # 2. build
    from mpnn_tpu_torch.ops import _build
    cached = _build.library_path().exists()
    t = time.perf_counter()
    _build.load()
    phase("build", build_s=round(time.perf_counter() - t, 3), cached=cached,
          library=os.path.relpath(str(_build.library_path()), HERE))

    # 3. the kernel's gradient
    phase("grad", **grad_phase(device))

    # 4. kernel against its plain version, stage by stage; then its net
    # axis, the stages of a sweep's nets in one launch per scale.
    rows = kernel_phase(device)
    net_rows = kernel_nets_phase(device)
    tail_rows = kernel_tails_phase(device)

    # 5. serve; the bf16 serving inside it is the main path, whose
    # launches are counted from 0.
    caps, records, launches, drift = serve_phase(device)
    check(launches > 0, "fused_mcm was not launched while serving")
    phase("serve_bf16", batch=BATCH, calibrated_capacities=caps,
          bf16_kernel_vs_plain=drift, records=records,
          fused_mcm_launches=launches)

    # 6. train: the kernel against mcm_ref for one step, then the training
    # main path in each precision, its launches counted from 0.
    phase("train_fp32_vs_plain", **train_vs_plain_phase(device))
    phase("train_bf16_vs_fp32", **train_bf16_vs_fp32_phase(device))
    train = {dt: train_phase(device, dt) for dt in ("fp32", "bf16")}
    for dt, rec in train.items():
        phase("train_" + dt, **rec)

    # 7. the sweep: one step through the net axis against mcm_ref, then
    # the sweep's training main path in each precision, its launches
    # counted from 0, beside the same call's single-net rate.
    phase("sweep_fp32_vs_plain", **sweep_vs_plain_phase(device))
    sweep = {dt: sweep_train_phase(device, dt, train[dt])
             for dt in ("fp32", "bf16")}
    sweep["bf16"]["bf16_vs_fp32"] = sweep_bf16_vs_fp32(device)
    for dt, rec in sweep.items():
        phase("sweep_train_" + dt, **rec)

    # 7a. C1: the serial and sweep steps' repeat with and without
    # deterministic algorithms, their rates in both modes, the NaN
    # check's cost.
    t = time.perf_counter()
    phase("repeat", **repeat_phase(device),
          phase_s=time.perf_counter() - t)

    # 7b. the 47-stage actor tree: one fp32 step against mcm_ref, its
    # training main path in each precision beside the chain's rate, then the
    # sweep of 8 trees; each path's launches counted from 0.
    phase("tree_train_fp32_vs_plain",
          **train_vs_plain_phase(device, "tree"))
    tree_train = {dt: train_phase(device, dt, "tree")
                  for dt in ("fp32", "bf16")}
    for dt, rec in tree_train.items():
        phase("tree_train_" + dt, chain_value=train[dt]["value"], **rec)
    tree_sweep_check = sweep_vs_plain_phase(device, "tree")
    tree_sweep = {dt: sweep_train_phase(device, dt, tree_train[dt], "tree")
                  for dt in ("fp32", "bf16")}
    phase("tree_sweep_train_fp32", vs_plain=tree_sweep_check,
          **tree_sweep["fp32"])
    phase("tree_sweep_train_bf16", **tree_sweep["bf16"])

    # 7c. the tree with stacked tails (ops.config.stacked_tails): one fp32
    # step against the serial step and against mcm_ref, its training main
    # path in each precision beside the serial tree's of 7b, then the
    # sweep of 8 trees (its tails a vmap inside the sweep's); each path's
    # launches counted from 0.
    phase("tree_stacked_vs_serial", **tree_stacked_vs_serial_phase(device))
    tree_stacked = {dt: train_phase(device, dt, "tree", stacked=True)
                    for dt in ("fp32", "bf16")}
    for dt, rec in tree_stacked.items():
        serial = tree_train[dt]
        phase("tree_stacked_train_" + dt, serial_value=serial["value"],
              serial_window_values=serial["window_values"],
              serial_profile=serial["profile"],
              vs_serial=rec["value"] / serial["value"], **rec)
    stacked_sweep_check = sweep_vs_plain_phase(device, "tree", stacked=True)
    tree_sweep_stacked = sweep_train_phase(device, "fp32", tree_train["fp32"],
                                           "tree", stacked=True)
    phase("tree_sweep_stacked", vs_plain=stacked_sweep_check,
          serial_sweep_value=tree_sweep["fp32"]["value"],
          serial_sweep_window_values=tree_sweep["fp32"]["window_values"],
          serial_sweep_profile=tree_sweep["fp32"]["profile"],
          vs_serial_sweep=(tree_sweep_stacked["value"]
                           / tree_sweep["fp32"]["value"]),
          **tree_sweep_stacked)

    # 7d. routed serving of the trained adaptive tree (its bf16 serving
    # counted from 0).
    serve_tree, tree = tree_serve_phase(device)
    phase("tree_serve", **serve_tree)

    import tempfile
    # Removed at the end: the mesh CLIs started in 7f are checked in 18-19.
    bg_dir = tempfile.TemporaryDirectory()
    bg = bg_dir.name
    # 7e. serving artifacts through torch.export (each artifact's
    # launches counted from 0 per served batch).
    chain_export, fresh = export_chain_phase(device, caps, bg)
    phase("export_chain", **chain_export)
    phase("export_adaptive", **export_adaptive_phase(device, tree[4]))

    # 12. a record in the reference's schema (it times its serving).
    with tempfile.TemporaryDirectory() as d:
        ref_import = reference_import_phase(device, d)
    phase("reference_import", **ref_import)

    # 7f-15. Phases that time no rate, in this process, beside the
    # processes of phases that time none either: the dry run (22), the
    # artifact's fresh process, check_parity's process, the tree's
    # artifact (export_tree: its export and load seconds), the training
    # CLI's path (8), the adaptive trainer's CLI (9) and the mesh CLIs
    # (18-19, checked after dp_nccl). The in-process phases: the tree's
    # descriptors beside its training's files, the compact archive's
    # writer, the parity harness against the float64 oracle, the rest
    # of the layer zoo, the TF1 parity modes and real-data prep; each
    # path's launches counted from 0 where it is the main path. Then
    # each process of 7f is waited for and checked.
    dirs = {k: os.path.join(bg, k) for k in (
        "dryrun", "child", "parity", "export_tree", "train_cli", "adaptive",
        "mesh")}
    for x in dirs.values():
        os.makedirs(x)
    dry_out = os.path.join(dirs["dryrun"], "dryrun.out")
    dryrun = start_dryrun(dry_out)
    child = parity_cli = tree_export = cli_runs = None
    adaptive_runs = mesh_clis = None
    try:
        t_bg = time.perf_counter()
        child = start_artifact_child(dirs["child"], *fresh[:2])
        parity_cli = start_parity_cli(dirs["parity"], tree[4])
        tree_export = start_export_tree(dirs["export_tree"], tree[4])
        # 8. the training CLI's path, serial and --vmap-sweep, its
        # launches counted from 0 in its process.
        cli_runs = start_phase_process("train_cli", dirs["train_cli"])
        adaptive_runs = start_adaptive_cli(dirs["adaptive"])
        mesh_clis = start_mesh_clis(dirs["mesh"])
        phase("tree_desc_vs_jax_files", **tree_desc_phase(device, tree))
        phase("compact", **compact_phase(device, tree))
        t_zoo = time.perf_counter()
        phase("zoo_layers", **zoo_layers_phase(device))
        phase("tf1_pyramid", **tf1_pyramid_phase(device))
        zoo_train = zoo_train_phase(device)
        phase("zoo_train", **zoo_train)
        phase("parity", **parity_phase(device, tree[4], parity_cli))
        # The CLIs of 14 and 15 leave deterministic algorithms on, as
        # the parallel phases after them have run since they joined.
        with tempfile.TemporaryDirectory() as d:
            tf1_cli = tf1_cli_phase(device, d)
        phase("tf1_cli", **tf1_cli)
        with tempfile.TemporaryDirectory() as d:
            prep_files = prep_files_phase(device, d)
        phase("prep_files", zoo_phases_s=time.perf_counter() - t_zoo,
              **prep_files)
        in_process_s = time.perf_counter() - t_bg
        cli = phase_process_result(cli_runs)
        phase("train_cli", **cli)
        tree_cli = {r["run"]: r["launches"] for r in cli["runs"] + cli[
            "sweep_runs"] if "-tree" in r["run"]}
        phase("export_tree", **phase_process_result(tree_export))
        phase("export_process", **artifact_child_phase(
            "export_chain process", child, fresh[2],
            PER_FORWARD["chain"]))
        phase("dryrun", **dryrun_phase(dryrun, dry_out))
        adaptive = adaptive_cli_phase(device, dirs["adaptive"],
                                      adaptive_runs)
        phase("adaptive_cli", in_process_beside_s=in_process_s,
              side_by_side_s=time.perf_counter() - t_bg, **adaptive)
    except BaseException:
        _kill(mesh_clis)
        raise
    finally:
        stop_dryrun(dryrun)
        for started in (child, parity_cli, tree_export, cli_runs):
            if started is not None and started[0].poll() is None:
                started[0].kill()
                started[0].wait()
        if adaptive_runs is not None:
            adaptive_runs[2].set()
            adaptive_runs[0].join(60)
    del tree

    # 16-20. parallelism: data-parallel ranks sharing the card over gloo,
    # world size 1 over NCCL, the sweep mesh and torchrun through the CLI,
    # and remat under the sweep step; each rank's launches counted from 0
    # in its own process.
    t_par = time.perf_counter()
    try:
        dp = dp_train_phase(device, train["fp32"])
        phase("dp_train", **dp)
        phase("dp_nccl", **dp_nccl_phase(device))
        sweep_mesh, mesh_cli = mesh_cli_phases(device, dirs["mesh"],
                                               mesh_clis)
    finally:
        _kill(mesh_clis)
        bg_dir.cleanup()
    phase("sweep_mesh", **sweep_mesh)
    phase("mesh_cli", **mesh_cli)
    sweep_remat = sweep_remat_phase(device)
    phase("sweep_remat", parallel_phases_s=time.perf_counter() - t_par,
          **sweep_remat)

    # 21. the mesh's 'model' axis: the flagship sharded over 1x2 and 2x2
    # meshes, the stacked tree over 1x2.
    t_tp = time.perf_counter()
    tp = tp_train_phase(device)
    phase("tp_train", tp_phase_s=time.perf_counter() - t_tp, **tp)

    bf = [r for r in rows if r["dtype"] == "bf16" and r["batch"] == BATCH]
    bound_ms, bound_by = bound(sum(r["bytes"] for r in bf),
                               sum(r["flops"] for r in bf), "bf16")
    f32 = [r for r in rows if r["dtype"] == "fp32" and r["batch"] == BATCH]
    f32_bound_ms, f32_bound_by = bound(sum(r["bytes"] for r in f32),
                                       sum(r["flops"] for r in f32), "fp32")
    nb = [r for r in net_rows if r["dtype"] == "bf16"]
    nb_bound_ms, nb_bound_by = bound(sum(r["bytes"] for r in nb),
                                     sum(r["flops"] for r in nb), "bf16")
    print(json.dumps({"kernels": [{
        "name": "fused_mcm",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "launches": launches,
        "train_launches": {dt: r["fused_mcm_launches"]
                           for dt, r in train.items()},
        "train_cli_launches": {"total": cli["fused_mcm_launches"],
                               **{r["run"]: r["launches"]
                                  for r in cli["runs"]}},
        "tree_launches": {"tree_train_bf16":
                          tree_train["bf16"]["fused_mcm_launches"],
                          "tree_serve": serve_tree["fused_mcm_launches"]},
        "dtype": "bf16",
        "work": "the eight flagship stages, batch %d, one call each"
                % BATCH,
        "max_abs_err": max(r["max_abs_err"] for r in bf),
        "ms": sum(r["ms"] for r in bf),
        "plain_ms": sum(r["plain_ms"] for r in bf),
        "timing": "ms, plain_ms and library_ms: CUDA events around one call "
                  "from Python (median of 25), host work included; "
                  "*device_ms: device time, CUDA graphs of 10 calls "
                  "replayed between CUDA events",
        "device_ms": sum(r["device_ms"] for r in bf),
        "plain_device_ms": sum(r["plain_device_ms"] for r in bf),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sum(r["cudnn_conv_sequence_ms"] for r in bf),
        "library_device_ms": sum(r["cudnn_conv_sequence_device_ms"]
                                 for r in bf),
        "library_call": "the cuDNN conv2d sequence mcm_ref makes "
                        "(2L-1 convs per stage, pools precomputed)",
        "design": "bf16: mma.sync m16n8k16 implicit GEMM, BM=64 pixels x "
                  "BN=16-128 channels a block, one tap x 16 channels a K "
                  "step, three K steps staged in shared memory per "
                  "barrier, one launch per output scale; fp32: the entry "
                  "'fused_mcm, fp32'",
        "stages": rows,
    }, {
        "name": "fused_mcm, fp32",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "entry": "mcm_scale_forward and mcm_scale_forward_nets, dtype 0 "
                 "(mcm_scale_tf32)",
        "launches": train["fp32"]["fused_mcm_launches"],
        "launches_on": "the fp32 training main path (train_fp32), counted "
                       "from 0",
        "train_cli_profiled_launches":
            cli["resume_vs_uninterrupted"]["launches"],
        "sweep_launches": sweep["fp32"]["fused_mcm_net_launches"],
        "tree_launches": {"tree_train_fp32":
                          tree_train["fp32"]["fused_mcm_launches"],
                          "adaptive_cli": adaptive["fused_mcm_launches"],
                          **tree_cli},
        "tf1_launches": {
            "reference_import_per_forward":
                ref_import["launches_per_forward"],
            "zoo_train_per_forward": zoo_train["launches_per_forward"],
            "tf1_cli": {r["run"]: r["launches"] for r in tf1_cli["runs"]},
            "prep_files": prep_files["fused_mcm_launches"]},
        "mesh_launches": {
            "dp_train_per_rank": dp["launches"],
            "dp_train_steps": dp["steps"],
            "mesh_cli_per_rank": [r["fused_mcm_launches"]
                                  for r in mesh_cli["rank_launches"]]},
        "tp_launches": {
            name: {"per_rank": m["launches"], "steps": m["steps"],
                   "sharded_per_forward": m["sharded_launches_per_forward"],
                   **({"tree_stacked_from_per_net_prev_per_forward":
                       m["tree_stacked"]["ext_net_launches_per_forward"]}
                      if "tree_stacked" in m else {})}
            for name, m in tp["meshes"].items()},
        "tp_scales": tp_summary(tp["kernel_at_rank_batch"]),
        "tp_net_axis": tp["net_axis_at_rank_batch"],
        "dtype": "fp32",
        "work": "the eight flagship stages, batch %d, one call each" % BATCH,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "max_rel_err_vs_f64": max(r["rel_err_vs_f64"] for r in rows
                                  if "rel_err_vs_f64" in r),
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "timing": "as the bf16 entry's",
        "device_ms": sum(r["device_ms"] for r in f32),
        "plain_device_ms": sum(r["plain_device_ms"] for r in f32),
        "bound_ms": f32_bound_ms,
        "bound_by": f32_bound_by.split()[0],
        "bound_rate": "3xTF32: 3 x FLOPs / 495 TFLOP/s",
        "library_ms": sum(r["cudnn_conv_sequence_ms"] for r in f32),
        "library_device_ms": sum(r["cudnn_conv_sequence_device_ms"]
                                 for r in f32),
        "library_call": "the cuDNN conv2d sequence mcm_ref makes, TF32 off",
        "design": "3xTF32 mma.sync m16n8k8 implicit GEMM (hi/lo split, "
                  "three products, fp32 totals every 8 mma steps); a "
                  "block of 128 pixels (64 for 128 channels) x 16-128 "
                  "channels; chunks of 8 channels x 9 taps, each chunk's "
                  "halo patch and B tiles through a 3-slot cp.async ring, "
                  "the patch split once and read by all 9 taps; one "
                  "launch per output scale",
    }, {
        "name": "fused_mcm, net axis",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "entry": "mcm_scale_forward_nets",
        "launches": sweep["bf16"]["fused_mcm_net_launches"],
        "sweep_launches": {dt: r["fused_mcm_net_launches"]
                           for dt, r in sweep.items()},
        "train_cli_sweep_launches": {r["run"]: r["launches"]
                                     for r in cli["sweep_runs"]},
        "tree_sweep_launches": {dt: r["fused_mcm_net_launches"]
                                for dt, r in tree_sweep.items()},
        "tree_stacked_launches": {
            dt: {"launches": r["fused_mcm_launches"],
                 "net_launches": r["fused_mcm_net_launches"],
                 "steps": r["steps"]} for dt, r in tree_stacked.items()},
        "tree_sweep_stacked_launches": {
            "fp32": tree_sweep_stacked["fused_mcm_net_launches"],
            "steps": tree_sweep_stacked["steps"]},
        "tail_stages": [tail_summary(tail_rows, n, dt)
                        for n, dtypes in TAIL_NETS.items() for dt in dtypes],
        "sweep_mesh_launches_per_rank": [
            r["fused_mcm_net_launches"]
            for r in sweep_mesh["rank_launches"]],
        "sweep_remat_launches": {
            p: r["launches"] for p, r in sweep_remat["policies"].items()},
        "dtype": "bf16",
        "work": "the eight flagship stages for %d nets x batch %d, stage "
                "0's input shared, one call each" % (N_NETS, TRAIN_BATCH),
        "max_abs_err": max(r["max_abs_err"] for r in nb),
        "ms": sum(r["ms"] for r in nb),
        "plain_ms": sum(r["plain_ms"] for r in nb),
        "timing": "as above; each call is torch.func.vmap of the stage "
                  "over the nets, as the sweep calls it",
        "device_ms": sum(r["device_ms"] for r in nb),
        "plain_device_ms": sum(r["plain_device_ms"] for r in nb),
        "bound_ms": nb_bound_ms,
        "bound_by": nb_bound_by,
        "library_ms": sum(r["library_ms"] for r in nb),
        "library_device_ms": sum(r["library_device_ms"] for r in nb),
        "library_call": "mcm_ref under torch.func.vmap over the nets "
                        "(cuDNN's grouped convs)",
        "plain": "mcm_ref on each net's slice, one net after another",
        "stages": net_rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [PROCESS_FLAG]:
        phase_process(*sys.argv[2:4])
    else:
        main()
