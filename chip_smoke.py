#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the hand-written kernels (and their bf16 instances) from
``cgnn_tpu_torch/ops/csrc`` with
nvcc (``fused_cgconv.cu``, ``fused_epilogue.cu``, ``neighbor_search.cu``,
``segment_sum.cu`` and ``windowed_gather.cu``, one nvcc each, in parallel,
into ``build/kernels``), then:

1. kernel phase — holds each of the six kernels against its plain PyTorch
   version on the card and times both beside the card's bound for the
   same work: CUDA events around back-to-back calls (``ms``), the
   profiler's device time (``device_ms``), and the host's time a wrapper
   call (``host_us``, 200 back-to-back calls, no sync inside). The calls
   rotate through copies of their inputs that total over twice the L2,
   so each reads its inputs from device memory, as the bound counts
   them. Kernel 1 (the whole-conv apply pass: a node pass, then a slot
   pass) runs at the flagship CGCNN's top serving rung (N=1784 nodes,
   M=12 slots, F=64, G=41), with its bound counted as the least work (the
   factored z) and, beside it, as z taken whole per slot
   (``bound_ms_before``), and its two launches' device times apart;
   kernels 2-5 (the stats pass, and the fused epilogue's apply,
   reduce and dz passes) at the training shape, a snug batch-256 pack of
   MP-like structures (N=7832), with kernel 1 there too; kernel 2 (kernel
   1's node pass, a stats slot pass, the partials' sum) with its bound
   counted as the least work and as z taken whole per slot, its three
   launches' and kernel 4's two launches' device times apart, and the
   same bits when handed a separate node pass's P; kernel 8 (the raw
   wire's periodic neighbor search) at the top raw rung (72 structure
   slots of S=64 atoms, K=125 images, M=12) on the admitted calibration
   structures plus padding slots (its bound counted as the least work and
   by the earlier count), then, each beside a padding slot, on the
   exact-tie simple cubic cell, on a dense 8-atom cell whose centers
   accept more candidates than the kernel's key queue holds, and on the
   cubic cell with M=8, an exact tie across the M-th slot;
   kernel 1 again on the graph the raw expander builds on the card at that
   rung (N=72x64=4608 node slots, padding and self-loop slots included).
   Seeded random features and conv parameters. Tolerances: elementwise
   outputs rtol 1e-4 / atol 1e-5; kernel 2's and 4's column sums within
   1e-4 / 5e-4 of their row's largest entry (sums of ~10^5 terms in
   another order), and bit-identical when run again; kernel 8's outputs
   (neighbors, distances, edge mask, edge counts) bit-equal to its plain
   version's and to its own on a second run. The bf16 instances of
   kernels 1, 2, 4 and 5 (rows ``1-bf16`` .. ``5-bf16``) at the training
   shape, its nodes and edges rounded to bf16 and z rematerialized in
   bf16 (kernel 1 also at the top serving rung): each held to its plain
   version (the f32 plain version on the widened inputs; kernel 5's bf16
   dz within one bf16 ulp) at the f32 tolerances, bit-equal to its f32
   instance on the widened inputs, kernels 2 and 4 to themselves run to
   run, and timed beside bounds that count nodes, edges and z at 2 bytes;
2. serve phase — boots ``load_server(wire='raw')`` on seeded random
   weights at full width (``cgconv_impl='pallas'``, batch 64, 3 rungs) and
   answers, from 4 client threads, a burst of 224 featurized MP-like
   graphs (path ``serve``), then one of 32 wire-form ``RawStructure``s
   (path ``serve_raw``: most staged raw, the rest featurized on the
   worker). It checks every answer against the unfused plain model on
   host-featurized copies (rtol 1e-4 / atol 1e-4), that in each run
   kernel 8 launched once per raw flush and kernel 1 ``n_conv`` times per
   flush, and reports each run's requests/s and latency. An overflow leg
   (``raw_precheck=False``, a one-atom 2 A cubic cell) must be answered
   through the featurized fallback, equal to its featurized answer. Then a
   featurized and a raw top-rung flush are broken down into pack, copy
   and step;
3. train phase — the port's ``fit`` at full width with
   ``cgconv_impl='pallas'``: 512 MP-like training structures (64 for
   validation), batch 256, train.py's SGD defaults, 2 epochs. Kernels 2, 4
   and 5 must launch exactly n_conv x train steps times and kernel 1
   n_conv x (train steps + eval batches), and kernel 1's node pass n_conv
   x (train steps + eval batches) times: one a conv, shared by the stats
   and apply passes of a train step; losses and MAEs finite; the
   trained weights are saved, served by ``load_server`` (8 requests, held
   to the trained model's own answers);
4. trajectory check — the same 5 steps on fixed batches from the same
   initial weights through the kernel path and the unfused plain path on
   the card: per-step loss and every final parameter and running statistic
   within rtol 1e-3 / atol 1e-4 (f32, 5 SGD steps). A 3-step run with
   ``fused_epilogue='pallas'`` (then one eval batch) must launch kernels
   3, 4 and 5 and give the plain path's first 3 losses;
5. train breakdown — for the kernel path, the plain path and the COO
   kernel path (``aggregation='pallas'``, below): train
   structures/s of the per-step loop, and a step split into host pack,
   host-to-device copy and step wall, with the device's busy time and
   idle share from a ``torch.profiler`` trace;
6. the flat COO layout — kernel 6 (the sorted segment sum) against its
   plain version and ``torch.segment_reduce`` at the COO training shape
   (a packed batch-256 batch: E=93,920 edges, N=7,832, F=64; seeded
   messages zeroed on padding edges, which all sit on node N-1), at the
   top COO serving rung (E=21,336, N=1,784), and at the training shape
   with the padding edges moved to a real node in the middle (N/2, the
   centers re-sorted, its messages not zeroed), rtol 1e-4 / atol 1e-5 and
   bit-identical run to run; kernel 7 (the windowed gather, which no entry
   point of the JAX package calls) bit-equal to its plain version and to
   ``index_select`` on the dense training batch at N=7,936 (the node
   capacity rounded up to 128), and zeros out of window on shuffled
   indices. Path ``train_coo``: ``fit`` with ``aggregation='pallas'``,
   ``dense_m=0``, same split, batch 256, 2 epochs, kernel 6 launched
   exactly n_conv x (3 x train steps + eval batches) times (a train
   step's aggregation and its two endpoint gathers' backward); a 5-step
   trajectory through ``'pallas'`` and ``'xla'`` aggregation within rtol
   1e-3 / atol 1e-4; the weights saved. Path ``serve_coo``:
   ``load_server(wire='auto')`` on them (it must log featurized-only),
   from 4 threads 224 featurized graphs and 32 ``RawStructure``s
   featurized at admission, every answer within rtol 1e-4 / atol 1e-4 of
   the plain model (``aggregation='xla'``) on host-featurized copies,
   kernel 6 launched n_conv times a flush; a top-rung flush breakdown;
7. checkpoint_predict — the port's train entry point
   (``cgnn_tpu_torch.train.__main__.main``) at full width with
   ``--cgconv-impl pallas``, 640 synthetic structures (512/64/64), batch
   256, 2 epochs into ``build/chip_smoke/ckpt`` (path ``train_main``,
   each kernel's launches exact): 2 committed saves, each verified
   against its manifest, ``best.json`` on the better one. The same run in
   memory through ``fit``, saved every epoch (the save's caller-thread
   ms), restored into a fresh state (the restore ms): every parameter,
   running statistic, optimizer buffer and the count bit-equal. One more
   epoch (``start_epoch=2``, same seed) from the restored and from the
   in-memory state: bit-equal, or else it names the op that breaks it
   (the run repeated from a copy of the in-memory state and again under
   PyTorch's deterministic algorithms) and holds every tensor to rtol
   1e-6 / atol 1e-7. ``--resume`` to 3 epochs prints ``resumed from ...
   at epoch 2`` (path ``train_main_resume``). ``cgnn_tpu_torch.predict``
   on 512 structures with ``--wire raw`` (path ``predict_raw``) and
   ``--wire featurized`` (path ``predict``): CSV ids in input order, each
   prediction within rtol 1e-4 / atol 1e-4 of the plain model
   (``cgconv_impl`` off) on the same graphs on the card, kernel 1 n_conv
   times a batch and kernel 8 once a raw batch; its structures/s;
8. cif_pipeline — real data through the entry points: 1024 MP-like
   synthetic structures written as CIFs with ``id_prop.csv`` under
   ``build/chip_smoke/cif`` (the port's ``write_cif_file``);
   ``python -m cgnn_tpu_torch.data.preprocess`` with ``-j 8`` (its
   structures/s; the cache bit-equal to an in-process
   ``load_cif_directory`` of the directory); the train entry point from
   ``DIR --cache``, batch 256, 2 epochs, ``--cgconv-impl pallas`` (path
   ``train_cif``, launches exact); the per-step loop with the prefetch
   loader and without it, in turns (on, off, off, on: step wall,
   ``loader_wait_ms`` a step, device idle share); the predict entry point
   on the cache at ``-b 16`` (64 batches, so the pooled pinned buffers
   recycle) with ``--compact on --pack-workers 2`` (path
   ``predict_compact``) and ``--compact off`` (path ``predict_cif_full``),
   in turns (on, off, off, on), and ``--wire raw`` from the directory
   (path ``predict_cif_raw``, kernel 8), each CSV within rtol 1e-4 / atol
   1e-4 of the plain model on the card; a ``compact_flush_breakdown`` of
   ``load_server(compact='on')`` on the calibration graphs (pack, copy,
   the expander's device ms, step), the compactability probe's host time
   a graph (one at a time, and batched as the worker runs it), and bursts of the 224 graphs (fresh copies each) through it and
   through the full-packing server in turns (compact, full, full,
   compact): the first compact burst is path ``serve_compact`` (every
   flush packed compact), its answers equal to the full server's;
9. step_graphs — every step above already runs as a replayed CUDA graph
   (train/graphs.py); then the train entry point as a user runs it under
   the epoch driver, ``--synthetic 2048 --device-resident --buckets 3 -b
   256 --epochs 3`` with ``--cgconv-impl pallas`` (path
   ``driver_compact``: compact staging ``auto`` -> on), again with
   ``--compact-staging off`` (``driver_full``) and with ``--aggregation
   pallas`` (``driver_coo``), no capture after warm-up, structures/s,
   staged bytes and host ms a step from its ``train:`` line; on 2048
   MP-like structures the driver's 2-epoch trajectory against the eager
   pack-once loop (bit-equal in every tensor under deterministic
   algorithms, metrics rel 1e-5 with and without); the default
   device-resident training (3 buckets, compact staging, the expander
   inside the graphs) against the same schedule stepped eagerly
   (bit-equal under deterministic algorithms) and against full staging
   (metrics within tests/test_compact.py's rel 2e-2), every staged batch's
   expansion within the expander's 2e-6 of its full pack; the driver
   against the eager per-step loop in turns (driver, loop, loop, driver;
   device idle share by the profiler); every rung of every serving form
   (full, compact, raw; COO) replayed against the eager step under
   deterministic algorithms;
10. resilience — the divergence guard inside the replayed train graphs,
   at full width with the kernel path, on the step_graphs phase's
   MP-like split (1638 training structures, one bucket, 3 epochs) and
   the train phase's: the guarded epoch driver (path ``guard_driver``)
   bit-equal in every tensor to the unguarded one from the same weights,
   no step skipped, no capture after warm-up, and both rates over epochs
   2-3 in turns (off, on, on, off); the per-step loop with graphs on 5
   fixed batches, the third NaN (``faultinject.poison_nan``): bit-equal
   to a run that never saw it, the same skipped step as the plain path
   (``guard_nan_loop``); ``nan_batch=1`` under the epoch driver, the staged
   poisoned batch skipped once each epoch, host count equal to the
   device count, kernel and plain path alike, dense (kernels 1, 2, 4, 5;
   ``guard_nan_driver``) and COO (kernel 6; ``guard_nan_coo``); one NaN
   in a node's features and one in an edge's, the targets finite, dense
   and COO (``guard_nan_features``, ``guard_nan_features_coo``): an
   unguarded step's loss and non-finite parameters equal the plain
   path's (NaN), and the guarded per-step loop skips the same steps on
   both paths, so a kernel that drops a NaN fails it; the
   driver with a ``DivergenceMonitor`` (max skips 1, 2 rollbacks) rolling
   back twice with the rate table cut in place to x0.25 and no capture
   after warm-up (``guard_rollback``), the cut restored from a save's
   meta into a fresh state, and one more epoch raising
   ``DivergenceError``; a preemption request polled by the epoch driver that
   stops epoch 1 after its first chunk, saved under epoch 0
   (``preempt_driver``); the train entry point in a subprocess
   (``--device-resident``, 640 structures, 120 epochs) SIGTERMed at its
   first commit (exit 75), resumed under ``crash=after_write:1:exit``
   (exit 137, the save before it still the newest), and resumed to its
   last epoch; COO training (kernel 6) run twice from the same weights
   and resumed from a checkpoint against the in-memory state, without
   deterministic algorithms: bit-equal in every tensor;
11. serve_http — the server as users run it, ``python -m
   cgnn_tpu_torch.serve CKPT`` over HTTP with serve.py's defaults (``-b
   64``, 3 rungs, 5 ms, 1000 ms deadline, a 1024-entry cache, the raw
   wire and compact staging on, one packer thread), each server a
   subprocess on a free port; the servers boot side by side in two
   groups (``serve_http`` with the two wire-form servers; the faults,
   wedge and COO servers), each group all ready before its first timed
   burst. Two checkpoints from the train entry point
   at flagship width (dense with ``--cgconv-impl pallas``, and COO with
   ``--aggregation pallas``), 640 structures, 2 epochs. Path
   ``serve_http``: ``/healthz`` must answer 503 (warming) before 200;
   192 featurized graphs as JSON from 16 keep-alive clients (a client's
   graph packs full), 32 of them again (every one a cache hit equal to its
   miss), 192 more with their priority classes mixed from 32 clients
   (every class answered, ``backfilled_total`` > 0), then SIGTERM 0.3 s
   into a 512-graph burst (``--drain-linger 2``): 200 or 503 only,
   ``/healthz`` 503 with draining true, exit 0. ``serve_http_raw``:
   192 wire-form structures (kernel 8 + kernel 1); ``serve_http_compact``:
   192 wire-form structures that the server featurizes on its packer
   thread (``--wire featurized``: compact flushes). Every answer held to
   the plain path (``cgconv_impl`` off) on host-featurized copies, rtol
   1e-4 / atol 1e-4, requests/s and client p50/p99 reported, p99 <= 1000
   ms. ``serve_http_reload`` (``--poll-interval 0.5``): clients loop over
   96 graphs and 96 structures while a second version (weights x1.25,
   normalizer mean + 1.5, std x1.5) is committed; no request fails,
   answers come from both versions, each within tolerance of the plain
   path under the version it reports, no old-version answer to a request
   sent after ``/healthz`` showed the swap, one reload, no capture after
   warm-up. Faults (``python -m``, untraced): ``dispatch_exc=2;
   exit75_at=8`` answers 200, 200, 500, 200, ... and exits 75;
   ``wedge_flush=1`` with ``--drain-timeout 3`` exits 3.
   ``serve_http_coo``: the COO checkpoint, 96 graphs and 96 structures
   featurized at admission (kernel 6). Each traced path runs the entry
   point inside ``PathRun`` in its own process (``traced_serve``) and is
   held by ``check_path`` to its warm-up replays and flushes. Then item
   14's turns in process: 1024 requests at once from 64 threads through a
   serial worker (``pack_workers=0``) and a pipelined one (1), serial,
   pipelined, pipelined, serial, for featurized graphs packed full,
   compact graphs and raw structures (64 MP-like calibration structures):
   requests/s, p99, the worker's pack share and its wait on the packer;
12. heads_modes (run right after the kernel phase) — the heads and
   modes at full width on 640 MP-like
   structures written as CIFs (``write_label_directories``: the
   regression targets, 0/1 labels by the median, and 4 multi-task
   columns with a quarter of the cells empty, over the same CIFs).
   bf16: the train entry point ``DIR --cache --bf16 --cgconv-impl pallas
   --device-resident --buckets 3`` (path ``hm_bf16_driver``: only the
   bf16 instances of kernels 1, 2, 4 and 5 launch, exactly; no capture
   after warm-up), full staging's bytes in bf16 against f32, a 5-step
   kernel-path vs plain-path trajectory in bf16 (BF16_TOL of each
   tensor's largest |entry|), the saved checkpoint through predict on the
   featurized, compact and raw wires (``hm_bf16_predict*``) and
   ``load_server`` (``hm_bf16_serve``, ``hm_bf16_serve_raw``), every
   answer within BF16_TOL of the largest |answer| of the bf16 plain path
   on host-featurized copies, each gap to the f32 model reported.
   Classification (``--task classification --dropout 0.1``, path
   ``hm_class_driver``, the ``class_eval`` line): a replayed train step
   bit-equal to an eager one from the same generator state, two replays
   from the same weights drawing different masks, the resumed epoch
   bit-equal to the uninterrupted one (the dropout generator restored),
   ``--resume`` (``hm_class_resume``), predict and serve
   (``hm_class_predict``, ``hm_class_serve``): two log-prob columns
   whose exp sums to 1 within 1e-5, rtol 1e-4 / atol 1e-4 of the plain
   path. Multi-task (``--multi-task-head --n-h 2``, ``hm_multitask``, the
   per-task MAE lines) served with 4 columns (``hm_multitask_serve``).
   The phase prints its seconds.
13. bf16_paths (right after heads_modes) — the bf16 instances of kernels
   3 and 6 on their paths, on 1024 synthetic cells at full width: the
   train entry point ``--bf16 --layout coo --aggregation pallas``
   (``bf16_coo_train``: only kernel 6's bf16 instance launches, in every
   aggregation and in the gathers' backward), predict
   (``bf16_coo_predict``) and a burst on the COO ladder
   (``bf16_coo_serve``); ``--bf16 --fused-epilogue pallas``
   (``bf16_epilogue_train``: only the bf16 instances of kernels 3, 4 and
   5) and predict (``bf16_epilogue_predict``, raw wire included). The
   kernel phase adds rows ``3-bf16`` (bf16 z at the training shape, an
   f32 sum equal to kernel 3's on the widened z) and ``6-bf16`` (bf16
   messages at the COO training shape, each sum kernel 6's on the
   widened messages, rounded; ``torch.segment_reduce`` on bf16 beside
   it).
14. force_task (last) — the force field at full width on 1024 synthetic LJ
   frames of 21 atoms (MD17 aspirin's count): the train entry point
   under the epoch driver, dense (``force_driver``), COO with
   ``--aggregation xla`` (``force_coo``) and bf16 (``force_bf16``), no
   kernel of the port on those paths (exact counts) and every step a
   replay, their rates; ``--resume`` (``force_resume``); predict on the
   test split (``force_predict``: every batch a replay, the CSV and
   ``.forces.npz`` against the eager step, rtol 1e-4 / atol 1e-4); a
   replayed force train step bit-equal to eager, two driver runs
   bit-equal and a resumed epoch bit-equal (deterministic algorithms);
   the forces against a central difference of the energy in f64 (step
   1e-4 A, within 1e-5 of the largest |F|); the step's device time split
   into forward, forces and the double backward; the refusals (a force
   checkpoint to ``load_server`` and the serve entry point,
   ``--aggregation pallas``, ``--compact-staging on``); and the
   regression task on 256 OC20-like slabs (``oc20_train``);
15. data_layer (after cif_pipeline) — the rest of the data layer: the
   native host neighbor search (cgnn_tpu_torch/native, built with g++)
   against the numpy one at 8 A on 64 MP-like cells, 8 OC20-like slabs
   and the four tie cells (SrTiO3, Cu, NaCl, Si): every array bit-equal,
   order included, the k-nearest cut at M too, ``backend_used()``
   native, ms a structure both ways; ``preprocess -j 8`` of the
   cif_pipeline directory with the native search and with the numpy one
   (PATH emptied: 'auto' resolves to numpy), the caches bit-equal, each
   rate; the train entry point from that cache at full width with
   ``--cgconv-impl pallas --packing ladder --check-invariants
   --scan-epochs`` (path ``data_ladder_train``: kernels 1, 2, 4, 5
   exact), then untraced ladder runs with the checks on, off, off, on
   (steady rates, the driver's ``check_s``) and a snug run (padding
   efficiencies from each run's ``PaddingStats``); COO with
   ``--aggregation pallas --node-cap 3000 --edge-cap 36000``
   (``data_coo_caps``: kernel 6 exact, every batch that shape); the
   predict entry point with ``--packing ladder --buckets 1`` on the
   ladder checkpoint (``data_predict_ladder``: kernel 1 exact) within
   rtol 1e-4 / atol 1e-4 of ``--packing snug``'s answers; the train
   entry point with ``--check-invariants`` on a corrupted copy of the
   cache (a subprocess: a non-zero exit naming the broken invariant); and
   two full-width ``fit`` runs under the driver, each dropped with the
   collector off: the second's allocation back to within 8 MiB of where
   it began, and a ``gc.collect()`` after either frees nothing.
16. data_parallel (after resilience) — data-parallel training as users
   run it, two ranks of the train entry point (``--data-parallel
   --dist-backend gloo``, the environment triple, each a process under
   ``PathRun`` through ``traced_train``) sharing the one card, at full
   width on a cache of 2048 MP-like structures (1638 train, ~819 a
   rank), batch 256 a rank, 3 epochs: ``dp_dense`` (``--cgconv-impl
   pallas``: kernels 1, 2, 4, 5) alone, then the one-process entry
   point on the same data for the rate (two ranks on one card say
   nothing of scaling), then ``dp_coo`` (``--aggregation pallas``:
   kernel 6) and ``dp_guard`` (dense, ``nan_batch=1`` in rank 1's
   environment only) side by side, the emulations below beside them. Each rank's launches exact
   against its own steps (paths ``<leg>.rank<r>``: graph A a train
   step, graph B ``train_apply``, every validation step padding
   included, the test batches); both ranks' state digests equal after
   every epoch, and their summed metrics and steps; no capture after
   warm-up; process 0 committed every epoch and no other rank wrote its
   ``--ckpt-dir`` or ``--out-dir``; ``dp_guard``'s ranks skipped the
   same steps (>= 1). ``dp_dense`` and ``dp_coo``'s per-epoch train loss
   and val MAE within rel 1e-5 of a one-process emulation on the card
   (the same shards and shuffles, each step's grad part for rank 0's
   batch and then rank 1's, the buckets summed and applied once).
   ``dp_predict``: the predict entry point on process 0's checkpoint,
   512 structures, rtol 1e-4 / atol 1e-4 of the plain path. A rank that
   fails or hangs (past ``DP_RANK_TIMEOUT_S``; a collective waits the
   process group's timeout, ``dist.DEFAULT_TIMEOUT_S``) is killed with
   its peers and fails the phase.
17. graph_shards (after data_parallel) — graph sharding as users run it,
   ranks of the train entry point sharing the one card over gloo
   (``DataParallelRun``), at full width: ``gs_dense`` (``--graph-shards
   2`` on data_parallel's cache of 2048 MP-like structures, batch 256, 2
   epochs: node strips on the plain dense path) alone, then one
   unsharded process of the entry point at the same ``--node-cap`` (the
   sharded run's, rounded to 8·G) for the rate; ``dp_force`` (``--task
   force --data-parallel``, 2 ranks, 1024 LJ frames of 21 atoms, Adam
   0.002, 2 epochs) alone, then its one-process run; then ``gs_coo``
   (``--graph-shards 2 --aggregation pallas`` on 256 OC20-like slabs,
   batch 64, node and edge caps given to both sides, 2 epochs: edge
   chunks through kernel 6) and ``gs_dp`` (``--data-parallel
   --graph-shards 2``, 4 ranks as 2 x 2, dense, 2 epochs) side by side,
   gs_coo's one unsharded process and the one-process emulations of
   gs_dp and dp_force beside them. Each leg: digests equal on every rank
   after every epoch; per-epoch train loss and val MAE (dp_force: force
   MAE) within rel 1e-4 (``GS_RTOL``) of its unsharded process or
   emulation; each rank's launches exact (paths ``<leg>.rank<r>``;
   sharded steps run eagerly, so no capture; kernel 6 on gs_coo's
   chunks; no kernel on the dense and force legs, as in the JAX
   package); process 0 alone writes; each rank's staged edge bytes
   (``train:``'s ``edge_bytes``) at most 1/G + 0.05 of the unsharded
   process's. ``gs_predict``: the predict entry point on gs_dense's
   process-0 checkpoint through the one-card path, 512 structures, rtol
   1e-4 / atol 1e-4 of the plain path. Train structures/s (frames/s) of
   the ranks and of one process are reported, no limit.
18. dp_driver (after graph_shards) — the epoch driver under a process
   group, ``--device-resident`` (its ``--scan-epochs`` default) with
   ``--data-parallel`` and ``--graph-shards``, ranks of the train entry
   point sharing the one card over gloo (``DataParallelRun``; each rank
   records its driver's chunks, ``record_driver_trace``), at full width:
   ``dpd_dense`` (2 ranks, ``--cgconv-impl pallas --buckets 3`` on
   data_parallel's 2048-structure cache, batch 256, 3 epochs: kernels 1,
   2, 4, 5 in graph A) alone, then one process under the driver on the
   same data and flags for the rate; then side by side ``dpd_coo`` (2
   ranks, ``--aggregation pallas``: kernel 6) and ``gsd_dense``
   (``--graph-shards 2`` at graph_shards' node cap), then ``gsd_coo``
   (``--graph-shards 2`` on graph_shards' slabs with kernel 6 on each
   rank's chunk) and ``dpd_force`` (``--task force``, 1024 LJ frames),
   2 epochs each, the emulations and unsharded references beside them.
   Each leg: the driver ran on every rank (staging recorded, no
   fall-back) and every rank ran the same chunks; digests equal after
   every epoch; per-epoch train loss and val MAE within rel 1e-5 of
   ``dp_emulation`` run on the driver's trace (each rank's shard packed
   once at the whole split's shapes and agreed as the ranks agree it), or
   rel 1e-4 (``GS_RTOL``) of one unsharded process under the driver for
   the sharded legs; no capture after warm-up on the replayed legs, none
   on the sharded ones (eager); launches exact on each rank; each
   ``gsd_*`` rank's staged edge bytes at most 1/G + 0.05 of one
   process's; only process 0 writes. ``dpd_preempt``: two ranks under
   the driver at batch 32, process 1 alone SIGTERMed at process 0's
   first commit: both exit 75 after the same preemption line, the save
   under epoch − 1 (mid-epoch), and ``--resume auto`` completes the run
   with equal digests. Train structures/s, each run alone: two ranks
   under the driver, two under the per-step loop (data_parallel's
   ``dp_dense``), one process under the driver; one card measures no
   scaling.

19. serve_devices_tiers (after serve_coo) — serving's device and
   precision dimensions. Tiers: the flagship trained by the train phase
   (dense, ``cgconv_impl='pallas'``), saved as a checkpoint directory,
   served in process with ``precision='f32,bf16,int8'`` on the raw wire:
   a burst of bf16 and int8 requests of the MP-like held-out split (path
   ``tiers_serve``) and one of wire-form structures (``tiers_serve_raw``)
   launch only the bf16 instances of kernels 1 (and kernel 8), exactly a
   conv a flush; the train_coo phase's COO weights alike
   (``tiers_serve_coo``, kernel 6's bf16 instance). Each tier's answers
   within BF16_TOL of the largest |answer| of its plain path (the tier
   over the unfused model; COO ``aggregation='xla'``), and each tier's MAE
   on the held-out split at most 1.005 of f32's. Then ``python -m
   cgnn_tpu_torch.serve --precision f32,bf16,int8`` over HTTP answers a
   mixed-tier burst, each answer in its tier and within BF16_TOL of its
   plain path, the MAE ratios again, an int8 request never answered by a
   cached f32 row, nothing captured after warm-up. Devices on the one
   card: ``predict --devices 2`` exits 2 with the no-clamp message;
   ``engine='mesh'`` over one entry reads ``single``; ``stage`` hands
   each entry of ``[cuda:0, cuda:0]`` its slice alone; bulk predict on
   both wires over ``[cuda:0, cuda:0]`` under both engines (paths
   ``devices_predict_{mesh,threads}``, ``devices_predict_raw_{mesh,
   threads}``), at DEV_BATCHES batches or more a wire so that every
   entry replays its captured graphs, bit-equal to one entry; in-process
   servers over the same set (``devices_serve_{mesh,threads}``) answer
   one request a flush bit-equal to a one-entry server, and a burst
   from every entry (both dispatch under threads); a hot swap under
   concurrent sharded dispatch leaves no client an answer of the old
   version after it has seen the new one, every answer within SERVE_RTOL
   of its version's weights.
   Structures/s an engine and requests/s a tier, no limit (one card
   measures no scaling).

20. tiers_raw_late (last) — ROADMAP Queue 3, item 13's probe: the
   ``tiers_serve_raw`` burst again on a fresh tiers server, late in the
   process (``tiers_serve_raw_late``): answers within BF16_TOL of the
   plain path, step and wrapper counts exact, every kernel of the path
   launched on the card, and whether the trace's count is exact
   recorded (``card_exact``), not held.
21. observe (after serve_devices_tiers) — the observability core as
   users run it: the train entry point at full width with the kernel
   path under the epoch driver (``--synthetic 640 --device-resident -b
   256 --epochs 8 --cgconv-impl pallas``) at ``--telemetry off`` (path
   ``observe_train_off``) and ``step`` (``observe_train_step``), launches
   exact; the two final states (every tensor of the newest save, and the
   parameter file) bit-equal; at ``step`` ``<ckpt>/logs/metrics.jsonl``
   holds one train record an optimizer step (steps 1..N, finite
   ``grad_norm``) and one eval record an eval step, ``trace.json``
   parses with its epoch and checkpoint spans, ``manifest.json`` names
   the card; at ``off`` no ``logs/``. Then ``python -m
   cgnn_tpu_torch.serve`` on the step run's checkpoint with
   ``--telemetry-dir`` (path ``observe_serve``, traced) answers a burst
   of featurized graphs and wire-form structures over HTTP; ``GET
   /metrics`` parses (``observe.export.parse_prometheus_text``) and each
   ``serve_*`` counter equals ``/stats``'s count, each rung's
   ``ingest_rung*_edge_occupancy`` lies in (0, 1] (a raw rung among
   them), and the drained server's ``metrics.jsonl`` ends with its
   ``run_summary`` and ``trace.json`` holds the request spans. Prints
   ``{"observe": ...}`` with the train steps/s of epochs 2-8 (their
   train and validation wall, traced) at ``off`` and ``step`` beside the
   card's name and power limit.

Every phase prints its seconds (``phase <name>: <s> s``).

Launches on a path. A replayed graph launches its kernels without their
wrappers, so each path's run (``PathRun``) is traced by the profiler,
and a kernel's ``launches`` on it are the card's count of that kernel
(``KERNEL_SYMBOLS``). ``check_path`` holds them exactly to the path's
own steps: each batch or flush one run of its step graph (the counts of
train/graphs.py against the batches this script counts, or the entry
point reports), each capture ``WARMUP_RUNS`` warm-up runs, each kernel
its launches a
step times the steps run, and its wrapper's count the same over the
steps that replayed no graph. Runs whose rates are compared in turns
are not traced.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
summary lines, and as the last line ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before that line; a run still going after
``HANG_DUMP_S`` seconds dumps every thread's stack and exits 1. Without
CUDA it exits 2 and prints no result.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types

RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain version: f32 roundoff, reordered sums
STATS_RTOL = 1e-4  # kernel 2's column sums, on their row's largest entry
REDUCE_RTOL = 5e-4  # kernel 4's (the JAX package's tolerance for d_scale/d_bias)
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4  # model outputs (|y| ~ 10-100)
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4  # kernel vs plain path: 5 f32 SGD steps
# the bf16 kernel path (f32 arithmetic on bf16 loads, as the TPU kernel)
# against the bf16 plain path (bf16 matmuls): of the reference's largest
# |entry|, plus BF16_ATOL for tensors near zero (fc_full's bias, whose
# gradient is roundoff under BN1), tests/test_torch_bf16.py's tolerance
BF16_TOL, BF16_ATOL = 2e-2, 1e-3
BF16_ULP = 2.0 ** -7  # kernel 5's bf16 dz vs its plain version: one ulp
# a resumed epoch vs the uninterrupted one, where not bit-equal (the op
# that breaks it is named in the output)
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2: the timers rotate inputs past twice this
SEED = 0
HANG_DUMP_S = 1190  # past it the run dumps its threads' stacks and exits 1
N_CLIENTS, N_GRAPHS, N_WIRE = 4, 224, 32
M = 12  # the flagship's max_num_nbr: dense edge slots per node
BATCH, EPOCHS = 256, 2
N_TRAIN_SET = 640  # split 0.8 / 0.1 / 0.1 -> 512 train, 64 val, 64 test
N_PREDICT = 512  # structures through the predict entry point, each wire
PREDICT_REPEATS = 5  # untraced runs of each, for the rate (their median)
N_CIF = 1024  # MP-like structures written as CIFs (cif_pipeline)
CIF_PREDICT_BATCH = 16  # 64 predict batches, so the pooled buffers recycle
PREPROCESS_WORKERS = 8
COO_AGG = "pallas"  # the COO paths' aggregation: kernel 6
NO_PATH = {"windowed_gather": "no entry point of the JAX package calls "
                              "windowed_gather (tests/test_ops.py:548 only)"}
NO_LIBRARY = {
    "neighbor_search": "no single PyTorch call computes the lexicographic "
                       "top-M periodic neighbor search",
    "fused_cgconv_eval": "no PyTorch call computes the gathered, gated conv",
    "fused_cgconv_stats": "no PyTorch call computes masked moments of the "
                          "gathered z without materializing it",
    "epilogue_apply": "no PyTorch call computes BN-apply + gate + masked sum",
    "epilogue_reduce": "no PyTorch call computes the gate's gradient sums",
    "epilogue_dz": "no PyTorch call computes the BN backward on masked slots",
}
# the bf16 instances (kernels 1, 2, 4, 5 on bf16 inputs): no library call
# either, for the same reasons
BF16_ROWS = {"fused_cgconv_eval_bf16": "1-bf16",
             "fused_cgconv_stats_bf16": "2-bf16",
             "epilogue_apply_bf16": "3-bf16",
             "epilogue_reduce_bf16": "4-bf16", "epilogue_dz_bf16": "5-bf16",
             "segment_sum_sorted_bf16": "6-bf16"}
NO_LIBRARY.update({k: NO_LIBRARY[k[: -len("_bf16")]] for k in BF16_ROWS
                   if k[: -len("_bf16")] in NO_LIBRARY})


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cold(fn, *args):
    """``fn`` on rotating copies of ``args`` (each tensor cloned) that
    together hold more than twice the card's L2, so that every call reads
    its inputs from device memory, as the bound counts them. -> a callable
    of no arguments, for the timers below."""
    import itertools

    import torch

    size = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    copies = [args] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(-(-2 * L2_BYTES // max(size, 1)) - 1)]
    nxt = itertools.cycle(copies).__next__
    return lambda: fn(*nxt())


def time_ms(fn, calls=20, trials=5, warmup=5):
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``trials``. Back to back,
    the device runs ahead of the host's launches, so host gaps between
    calls stay out of the time (events around a single short call would
    count them)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls=200):
    """Host time of one call, in microseconds: the wall time of ``calls``
    back-to-back calls (``time.perf_counter``, no sync inside), divided by
    ``calls``. The queue is drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def timings(fn, library_fn=None):
    """A kernel's times on its inputs: ``ms`` (CUDA events, ``time_ms``),
    ``device_ms`` (profiler), ``host_us``; the same for ``library_fn``, the
    one PyTorch call computing the same function, under ``library_*``."""
    out = {"ms": time_ms(fn), "device_ms": device_ms(fn),
           "host_us": host_us(fn)}
    if library_fn is not None:
        out.update(library_ms=time_ms(library_fn),
                   library_device_ms=device_ms(library_fn),
                   library_host_us=host_us(library_fn))
    return out


# each kernel's name in a trace of the card, by its wrapper's name: one
# launch of the wrapper is one launch of this kernel. A ``_bf16`` key is
# the same template instantiated on __nv_bfloat16 (``kernel_matches``)
KERNEL_SYMBOLS = {
    "fused_cgconv_eval": "fused_cgconv_eval_slot",  # either slot variant
    "fused_cgconv_node": "fused_cgconv_eval_node_kernel",
    "fused_cgconv_stats": "fused_cgconv_stats_slot_kernel",
    "epilogue_apply": "epilogue_apply_kernel",
    "epilogue_reduce": "epilogue_reduce_kernel",
    "epilogue_dz": "epilogue_dz_kernel",
    "neighbor_search": "neighbor_search_kernel",
    "segment_sum_sorted": "segment_sum_sorted_kernel",
    "windowed_gather": "windowed_gather_kernel",
    "fused_cgconv_eval_bf16": "fused_cgconv_eval_slot",
    "fused_cgconv_node_bf16": "fused_cgconv_eval_node_kernel",
    "fused_cgconv_stats_bf16": "fused_cgconv_stats_slot_kernel",
    "epilogue_apply_bf16": "epilogue_apply_kernel",
    "epilogue_reduce_bf16": "epilogue_reduce_kernel",
    "epilogue_dz_bf16": "epilogue_dz_kernel",
    "segment_sum_sorted_bf16": "segment_sum_sorted_kernel",
}


def kernel_matches(key: str, name: str) -> bool:
    """Whether the card's kernel ``name`` is a launch of ``key``'s kernel:
    its symbol, instantiated on bf16 for a ``_bf16`` key and on f32
    otherwise (the templates' demangled names carry their type)."""
    return (KERNEL_SYMBOLS[key] in name
            and ("bfloat16" in name) == key.endswith("_bf16"))


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; ``.launches`` counts the launches
    it made (``ops/_build.counted``: not those a graph replay makes)."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe
    from cgnn_tpu_torch.ops import neighbor_search as ns
    from cgnn_tpu_torch.ops import scatter
    from cgnn_tpu_torch.ops import windowed_gather as wg

    return {"fused_cgconv_eval": fc.fused_cgconv_eval_cuda,
            # kernel 1's node pass (also kernel 2's first launch), counted
            # apart: the training forward runs one a conv for both passes
            "fused_cgconv_node": fc.fused_cgconv_node_cuda,
            "fused_cgconv_stats": fc.fused_cgconv_stats_cuda,
            "epilogue_apply": fe.epilogue_apply_cuda,
            "epilogue_reduce": fe.epilogue_reduce_cuda,
            "epilogue_dz": fe.epilogue_dz_cuda,
            "neighbor_search": ns.neighbor_search_cuda,
            "segment_sum_sorted": scatter.segment_sum_sorted_cuda,
            "windowed_gather": wg.windowed_gather_cuda,
            "fused_cgconv_eval_bf16": fc.fused_cgconv_eval_bf16_cuda,
            "fused_cgconv_node_bf16": fc.fused_cgconv_node_bf16_cuda,
            "fused_cgconv_stats_bf16": fc.fused_cgconv_stats_bf16_cuda,
            "epilogue_apply_bf16": fe.epilogue_apply_bf16_cuda,
            "epilogue_reduce_bf16": fe.epilogue_reduce_bf16_cuda,
            "epilogue_dz_bf16": fe.epilogue_dz_bf16_cuda,
            "segment_sum_sorted_bf16": scatter.segment_sum_sorted_bf16_cuda}


def zero_counts() -> None:
    """Every kernel wrapper's count and the step graphs' counters at 0."""
    from cgnn_tpu_torch.train.graphs import reset_counts

    for w in kernel_wrappers().values():
        w.launches = 0
    reset_counts()


def read_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


# the margin a path's trace keeps at each edge of its window. Late in a
# long process a server burst, whose first replay starts a few ms after
# the trace does, lost the first record or two of that replay (with no
# margin, and with 0.05 s); the trace now also runs a kernel of its own
# before the path starts
PATH_WINDOW_MARGIN_S = 0.3


class PathRun:
    """One main path's run: ``with PathRun(label) as run:`` sets every
    wrapper's count and the step graphs' counters (train/graphs.py
    ``COUNTS``) to 0 just before and traces the card's kernels with the
    profiler (CUDA activity alone); just after, ``run.launches`` holds
    each kernel's launches on the card in the run (by ``KERNEL_SYMBOLS``,
    the graph replays' included), ``run.wrapper`` the wrappers' counts
    (the launches they made: eager steps and warm-up runs) and
    ``run.steps`` the step graphs' counters."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        zero_counts()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(PATH_WINDOW_MARGIN_S)
        return self

    def __exit__(self, kind, exc, tb):
        import torch

        from cgnn_tpu_torch.train.graphs import COUNTS

        torch.cuda.synchronize()
        time.sleep(PATH_WINDOW_MARGIN_S)
        self.prof.stop()
        self.wrapper = read_counts()
        self.steps = dict(COUNTS)
        kernels = [(e.key, e.count) for e in self.prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        self.launches = {k: sum(c for name, c in kernels
                                if kernel_matches(k, name))
                         for k in KERNEL_SYMBOLS}
        self.prof = None
        return False


def dense_per_step(n_conv: int, epilogue: bool = False,
                   bf16: bool = False) -> dict:
    """Each kernel's launches a step, by kind of step, on the dense
    layout: kernel 1's node and slot passes a conv in every forward, with
    kernels 2, 4 and 5 a conv in a train step (the forward shares one
    node pass a conv); the raw wire adds kernel 8 once a step. With
    ``epilogue`` (``fused_epilogue='pallas'``, kernel 1 off): kernel 3 a
    conv in every forward, kernels 4 and 5 a conv in a train step. With
    ``bf16``: the bf16 instances of kernels 1-5 in place of the f32 ones
    (kernel 8 is the same kernel)."""
    n = n_conv
    sfx = "_bf16" if bf16 else ""
    if epilogue:
        fwd = {f"epilogue_apply{sfx}": n}
        train = fwd | {f"epilogue_reduce{sfx}": n, f"epilogue_dz{sfx}": n}
    else:
        fwd = {f"fused_cgconv_eval{sfx}": n, f"fused_cgconv_node{sfx}": n}
        train = fwd | {f"fused_cgconv_stats{sfx}": n,
                       f"epilogue_reduce{sfx}": n, f"epilogue_dz{sfx}": n}
    return {"train": train, "eval": fwd, "predict": fwd,
            "predict_raw": fwd | {"neighbor_search": 1}}


def coo_per_step(n_conv: int, bf16: bool = False) -> dict:
    """The COO layout with aggregation='pallas': kernel 6 a conv in
    every step's aggregation, and in a train step twice more a conv, in
    the backward of the two endpoint gathers (ops/segment.py
    ``gather_fixed_order``); its bf16 instance alone with ``bf16``."""
    k6 = "segment_sum_sorted_bf16" if bf16 else "segment_sum_sorted"
    one = {k6: n_conv}
    return {"train": {k6: 3 * n_conv}, "eval": one, "predict": one}


def check_path(run, per_step: dict, logical: dict,
               outside: dict | None = None, card_exact: bool = True) -> dict:
    """Hold a path's run (``PathRun``) to its steps. ``logical``: the
    steps of each kind the path takes (batches and flushes, counted by
    this script or the entry point's report), each of which must be one
    ``run`` of a step graph; a capture adds ``WARMUP_RUNS[kind]`` warm-up
    runs; ``outside``: steps called directly, not
    through a step graph. Each kernel's launches on the card must equal
    its launches a step (``per_step``) times the steps run (runs plus
    warm-up runs), and its wrapper's count the same over the steps that
    did not replay a graph. With ``card_exact=False`` (ROADMAP Queue 3,
    item 13's probe) the card's count is recorded (``card_exact``,
    ``card_want``) instead: each kernel of the path must still launch on
    the card, and the step and wrapper counts are held as always. -> the
    run's record."""
    from cgnn_tpu_torch.train.graphs import KINDS, WARMUP_RUNS

    outside = outside or {}
    st = run.steps
    for kind in KINDS:
        runs, warm = st[f"{kind}_runs"], st[f"{kind}_warm_runs"]
        check(runs == logical.get(kind, 0)
              and warm == st[f"{kind}_captures"] * WARMUP_RUNS[kind],
              f"{run.label}: {kind} step runs {runs}, warm-up runs {warm}, "
              f"captures {st[f'{kind}_captures']}: want {logical.get(kind, 0)}"
              f" runs and {WARMUP_RUNS[kind]} warm-up runs a capture")
    card = dict.fromkeys(KERNEL_SYMBOLS, 0)
    made = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for kind, kernels in per_step.items():
        ran = st[f"{kind}_runs"] + st[f"{kind}_warm_runs"] + outside.get(
            kind, 0)
        eager = ran - st[f"{kind}_replays"]
        for k, n in kernels.items():
            card[k] += n * ran
            made[k] += n * eager
    exact = run.launches == card
    check((exact or not card_exact) and run.wrapper == made
          and all(run.launches[k] > 0 for k, n in card.items() if n),
          f"{run.label}: launches on the card {run.launches} (want {card}), "
          f"by the wrappers {run.wrapper} (want {made}); steps {st}")
    rec = {"launches": run.launches, "wrapper_launches": run.wrapper,
           "replayed_launches": {k: v - run.wrapper[k]
                                 for k, v in run.launches.items() if v},
           "step_counts": {k: v for k, v in st.items() if v}}
    if not card_exact:
        rec.update(card_exact=exact, card_want=card)
    print(f"{run.label}: {json.dumps(rec, allow_nan=False)}: ok")
    return rec


def compare(name, got, want, rtol, atol=0.0, row_scale=False):
    """Hold a kernel's output to its plain version's -> (max abs, max rel)
    error. ``row_scale``: column sums, each row held to rtol of its
    largest entry."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: output is not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if row_scale:
        scale = want.abs().amax(dim=-1, keepdim=True)
        ok = bool((err <= rtol * scale).all())
        tol = f"rtol {rtol} of each row's largest entry"
    else:
        ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
        tol = f"rtol {rtol}, atol {atol}"
    print(f"{name} at {tuple(got.shape)}: max_abs_err={max_abs!r} "
          f"max_rel_err={max_rel!r} ({tol}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} kernel disagrees with its plain version")
    return max_abs, max_rel


def bound(cost):
    """-> (ms, 'bytes' or 'operations'): the larger of a cost's compulsory
    bytes at HBM rate and its f32 operations at the non-tensor-core peak."""
    bytes_ms = cost["bytes"] / PEAK_BYTES * 1e3
    ops_ms = cost["flops"] / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


# the kernels redesigned with a vector and a scalar path (kernels 3 and
# 5): each row's template symbol, its vector width and its z type in the
# mangled names of ptxas's report
VECTOR_ROWS = {"epilogue_apply": ("epilogue_apply_kernel", 4, "f"),
               "epilogue_dz": ("epilogue_dz_kernel", 4, "f"),
               "epilogue_apply_bf16": ("epilogue_apply_kernel", 8,
                                       "13__nv_bfloat16"),
               "epilogue_dz_bf16": ("epilogue_dz_kernel", 8,
                                    "13__nv_bfloat16")}


def ptxas_usage(log: str, row: str) -> dict:
    """A ``VECTOR_ROWS`` row's registers and spill bytes from nvcc's
    ``-Xptxas -v`` report: its vector path and its scalar path (V = 1),
    each {"v", "registers", "spill_stores", "spill_loads"}, None where the
    report lacks it (a library built by an earlier process)."""
    symbol, wide, ztype = VECTOR_ROWS[row]
    found: dict = {}
    cur = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{symbol}ILi(\d+)E{ztype}E", line)
            cur = found.setdefault(int(m.group(1)), {}) if m else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return {path: ({"v": v, **found[v]} if v in found else None)
            for path, v in (("vector", wide), ("scalar", 1))}


K1_PARTS = {"node_pass": "eval_node_kernel", "slot_pass": "eval_slot"}
K2_PARTS = {"node_pass": "eval_node_kernel", "slot_pass": "stats_slot",
            "partial_sum": "sum_partials"}
K4_PARTS = {"reduce": "epilogue_reduce_kernel", "partial_sum": "sum_partials"}


def kernel_entry(name, source, replaces, errs, times, plain_ms, cost,
                 library_call=None):
    """One kernel's record for the ``kernels`` line, with its ``bound``;
    ``times`` from ``timings``: where ``library_call`` names the one
    PyTorch call that computes the same function, its ``library_*``
    times."""
    bound_ms, bound_by = bound(cost)
    library_ms = times.get("library_ms")
    lib = (f"library ({library_call}) {library_ms!r} ms" if library_call
           else f"library_ms null: {NO_LIBRARY[name]}")
    print(f"{name}: {times['ms']!r} ms a call (device "
          f"{times['device_ms']!r} ms, host {times['host_us']!r} us), "
          f"{plain_ms!r} ms plain; {cost['flops']} FLOP, {cost['bytes']} B "
          f"-> bound {bound_ms!r} ms; {lib}")
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"cgnn_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": 0,  # set from the main-path runs
        "max_abs_err": errs[0],
        "max_rel_err": errs[1],
        "ms": times["ms"],
        "device_ms": times["device_ms"],
        "host_us": times["host_us"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    if library_call:
        entry.update(library_call=library_call,
                     library_device_ms=times["library_device_ms"],
                     library_host_us=times["library_host_us"])
    else:
        entry["library_ms_null_because"] = NO_LIBRARY[name]
    return entry


def conv_inputs(dev, batch, f=64):
    """Seeded random conv inputs on the card for a packed batch: nodes,
    edges, fc_full kernel and bias, bn1 scale and bias, neighbors, the
    [N, M] edge mask, and a running mean and var."""
    import numpy as np
    import torch

    n, m, g = batch.edges.shape
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (
        t(rng.standard_normal((n, f))),  # nodes
        batch.edges.to(dev),
        t(rng.standard_normal((2 * f + g, 2 * f)) / np.sqrt(2 * f + g)),
        t(0.1 * rng.standard_normal(2 * f)),  # fc_full bias
        t(rng.uniform(0.5, 1.5, 2 * f)),  # bn1 scale
        t(0.2 * rng.standard_normal(2 * f)),  # bn1 bias
        batch.neighbors.to(dev),
        batch.edge_mask.reshape(n, m).contiguous().to(dev),
        t(0.3 * rng.standard_normal(2 * f)),  # running mean
        t(rng.uniform(0.5, 2.0, 2 * f)),  # running var
    )


def slot_counts(batch):
    mask = batch.edge_mask.reshape(batch.edges.shape[:2]).cpu().numpy() > 0
    return int(mask.sum()), int(mask.any(axis=1).sum())


def conv_bounds(batch, f=64):
    """Kernel 1's bound on a packed batch, counted as the least work (the
    factored z) and, beside it, as z taken whole per slot (the count
    before the node pass existed) -> (cost, bound_ms, bound_by,
    bound_ms_before, bound_by_before)."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc

    n, m, g = batch.edges.shape
    real_slots, real_rows = slot_counts(batch)
    cost = fc.eval_pass_cost(n, m, g, f, real_slots, fc.touched_nodes(
        batch.neighbors.cpu(), batch.edge_mask.cpu(), n))
    before = {"bytes": cost["bytes"],
              "flops": fc.unfactored_flops(f, g, real_slots, real_rows)}
    return (cost, *bound(cost), *bound(before))


def by_launch(fn, parts) -> dict:
    """Device ms of one call of ``fn`` split by launch: ``parts`` maps a
    part's name to a substring of its kernels' names (profiler, 20 calls)."""
    _, by_kernel, _ = device_busy_ms(fn, 20)
    return {part: sum(v for k, v in by_kernel.items() if key in k)
            for part, key in parts.items()}


def kernel_phase(dev, calibration, shape_set):
    """Kernel 1 at the top serving rung against its plain version, timed
    beside its two bounds, its two launches' device times apart."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc

    batch = shape_set.pack_full(calibration, shape=shape_set.largest)
    args = conv_inputs(dev, batch)
    errs = compare("fused_cgconv_eval", fc.fused_cgconv_eval_cuda(*args),
                   fc.fused_cgconv_eval_reference(*args), RTOL, ATOL)
    cost, _, _, before_ms, before_by = conv_bounds(batch)
    entry = kernel_entry(
        "fused_cgconv_eval", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:305", errs,
        timings(cold(fc.fused_cgconv_eval_cuda, *args)),
        time_ms(cold(fc.fused_cgconv_eval_reference, *args)), cost)
    split = by_launch(cold(fc.fused_cgconv_eval_cuda, *args), K1_PARTS)
    print(f"fused_cgconv_eval: bound before the node pass {before_ms!r} ms "
          f"({before_by}); device ms by launch {split}")
    entry.update(bound_ms_before=before_ms, bound_by_before=before_by,
                 device_ms_by_launch=split)
    return entry


def train_kernel_phase(dev, train_graphs):
    """Kernels 2-5 at the training shape (a snug batch-256 pack) against
    their plain versions; kernels 2 and 4 also against themselves, kernel
    2 also on a shared node pass. Kernel 1 at the same shape, its two
    launches apart. -> (entries of kernels 2-5, kernel 1's record at the
    training shape)."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    node_cap, edge_cap = capacities_for(train_graphs, BATCH, dense_m=M)
    batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                     edge_cap, dense_m=M, in_cap=0,
                                     snug=True)))
    n, m, g = batch.edges.shape
    f = 64
    cargs = conv_inputs(dev, batch)
    nodes, edges, kernel, bias, scale, bn_bias, nbr, emask, _, _ = cargs
    real_slots, real_rows = slot_counts(batch)
    print(f"training shape: N={n} M={m} F={f} G={g}, {real_slots} real "
          f"slots, {int(batch.graph_mask.sum())} structures")
    entries = []

    # kernel 1 at the training shape (the training forward's apply pass)
    k1_errs = compare("fused_cgconv_eval at the training shape",
                      fc.fused_cgconv_eval_cuda(*cargs),
                      fc.fused_cgconv_eval_reference(*cargs), RTOL, ATOL)
    _, bound_ms, bound_by, before_ms, before_by = conv_bounds(batch)
    k1_train = {"N": n, "max_abs_err": k1_errs[0],
                "max_rel_err": k1_errs[1],
                **timings(cold(fc.fused_cgconv_eval_cuda, *cargs)),
                "plain_ms": time_ms(
                    cold(fc.fused_cgconv_eval_reference, *cargs)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_before": before_ms, "bound_by_before": before_by,
                "device_ms_by_launch": by_launch(
                    cold(fc.fused_cgconv_eval_cuda, *cargs), K1_PARTS)}
    print(f"fused_cgconv_eval at the training shape (N={n}): "
          f"{k1_train['ms']!r} ms a call (device {k1_train['device_ms']!r}"
          f" ms, by launch {k1_train['device_ms_by_launch']}), bound "
          f"{bound_ms!r} ms")

    # kernel 2, the stats pass: alone, again, and on a shared node pass
    shift = fc._shift_row0(nodes, edges, kernel, bias, nbr, torch.float32)
    sargs = (nodes, edges, kernel, bias, nbr, emask, shift)
    got = fc.fused_cgconv_stats_cuda(*sargs)
    again = fc.fused_cgconv_stats_cuda(*sargs)
    p = fc.fused_cgconv_node_cuda(nodes, kernel, bias)
    shared = fc.fused_cgconv_stats_cuda(*sargs, p=p)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 2 differs from run to run")
    check(torch.equal(got, shared),
          "kernel 2 on a shared node pass differs from kernel 2 alone")
    compare("the node pass (P)", p,
            fc.node_projections_reference(nodes, kernel, bias), RTOL, ATOL)
    errs = compare("fused_cgconv_stats", got,
                   fc.fused_cgconv_stats_reference(*sargs), STATS_RTOL,
                   row_scale=True)
    touched = fc.touched_nodes(batch.neighbors, batch.edge_mask, n)
    cost = fc.stats_pass_cost(n, m, g, f, real_slots, touched)
    before_ms, before_by = bound(
        {"bytes": cost["bytes"],
         "flops": fc.unfactored_flops(f, g, real_slots, real_rows)
         + 3 * real_slots * 2 * f})
    entry = kernel_entry(
        "fused_cgconv_stats", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:277", errs,
        timings(cold(fc.fused_cgconv_stats_cuda, *sargs)),
        time_ms(cold(fc.fused_cgconv_stats_reference, *sargs)), cost)
    split = by_launch(cold(fc.fused_cgconv_stats_cuda, *sargs), K2_PARTS)
    print(f"fused_cgconv_stats: bound before the factored z {before_ms!r} "
          f"ms ({before_by}); device ms by launch {split}")
    entry.update(bound_ms_before=before_ms, bound_by_before=before_by,
                 device_ms_by_launch=split)
    entries.append(entry)

    # kernels 3-5 on the materialized z of the same conv
    z = fc._z_structured(nodes, edges, kernel, bias, nbr,
                         torch.float32).contiguous()
    mean, var, n_real = fe.masked_stats(z, emask)
    cst = fe.pack_cst(mean, torch.rsqrt(var + 1e-5), scale, bn_bias)
    ct = torch.randn(n, f, device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    errs = compare("epilogue_apply", fe.epilogue_apply_cuda(z, emask, cst),
                   fe.epilogue_apply_reference(z, emask, cst), RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_apply", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:142", errs,
        timings(cold(fe.epilogue_apply_cuda, z, emask, cst)),
        time_ms(cold(fe.epilogue_apply_reference, z, emask, cst)),
        fe.epilogue_pass_cost("apply", n, m, f, real_slots)))

    got = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    again = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 4 differs from run to run")
    red = fe.epilogue_reduce_reference(z, emask, cst, ct)
    errs = compare("epilogue_reduce", got, red, REDUCE_RTOL, row_scale=True)
    entry = kernel_entry(
        "epilogue_reduce", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:152", errs,
        timings(cold(fe.epilogue_reduce_cuda, z, emask, cst, ct)),
        time_ms(cold(fe.epilogue_reduce_reference, z, emask, cst, ct)),
        fe.epilogue_pass_cost("reduce", n, m, f, real_slots))
    entry["device_ms_by_launch"] = by_launch(
        cold(fe.epilogue_reduce_cuda, z, emask, cst, ct), K4_PARTS)
    print(f"epilogue_reduce: device ms by launch "
          f"{entry['device_ms_by_launch']}")
    entries.append(entry)

    inv_c = torch.full((1, 2 * f), 1.0 / max(float(n_real), 1.0),
                       device=dev)
    red5 = torch.cat([red, inv_c]).contiguous()
    errs = compare("epilogue_dz", fe.epilogue_dz_cuda(z, emask, cst, red5, ct),
                   fe.epilogue_dz_reference(z, emask, cst, red5, ct),
                   RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_dz", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:175", errs,
        timings(cold(fe.epilogue_dz_cuda, z, emask, cst, red5, ct)),
        time_ms(cold(fe.epilogue_dz_reference, z, emask, cst, red5, ct)),
        fe.epilogue_pass_cost("dz", n, m, f, real_slots)))
    return entries, k1_train


def search_kernel_phase(dev, calibration, shape_set):
    """Kernel 8 at the top raw rung against its plain version (every
    output bit-equal, and the same bits on a second run), then on three
    small cells beside a padding slot (exact ties, a queue that flushes
    mid-search, a tie across the M-th slot); and kernel 1 on the
    graph the raw expander builds on the card at that rung. -> (kernel 8's
    entry, kernel 1's record at the top raw rung)."""
    import numpy as np

    from cgnn_tpu_torch.data.rawbatch import (
        RawStructure,
        pack_raw,
        raw_from_graph,
    )
    from cgnn_tpu_torch.data.structure import Structure
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import neighbor_search as ns

    spec = shape_set.raw
    raws = [r for r in map(raw_from_graph, calibration) if spec.admits(r)]
    rb = shape_set.pack_raw(raws, shape=shape_set.largest).to(dev)
    g, s = rb.atom_mask.shape
    k, m = spec.n_images, spec.dense_m
    print(f"raw top rung: G={g} S={s} K={k} M={m}, {len(raws)} of "
          f"{len(calibration)} calibration structures admitted")
    args = (rb.frac, rb.lattices, rb.atom_mask, ns.offsets_tensor(spec, dev),
            spec.radius, spec.home_image, m)
    errs, filled = search_equal("neighbor_search", args)
    cubic = RawStructure.from_structure(
        Structure(np.eye(3) * 3.0, [[0.0, 0.0, 0.0]], [29]))
    # 8 atoms in a 4 Å cube: ~270 candidates within 8 Å a center, ~67
    # for each of its four warps, more than a warp's 64-key queue holds:
    # the queue flushes into the lane lists mid-search
    dense = RawStructure.from_structure(Structure(
        np.eye(3) * 4.0, np.random.default_rng(11).random((8, 3)),
        [11, 17] * 4))
    small = dataclasses.replace(spec, snode_cap=8, images=(3, 3, 3))
    for label, item, mm in (
            ("exact-tie cubic cell", cubic, m),
            ("dense cell, the queue flushing mid-search", dense, m),
            # 6 first-shell images, then 2 of the 12 tied second-shell
            # ones: the tie at the M-th slot is decided across lanes' lists
            ("exact tie across the M-th slot (M=8)", cubic, 8)):
        tb = pack_raw([item], 2, dataclasses.replace(small, dense_m=mm)
                      ).to(dev)
        search_equal(f"neighbor_search, {label} + a padding slot",
                     (tb.frac, tb.lattices, tb.atom_mask,
                      ns.offsets_tensor(small, dev), small.radius,
                      small.home_image, mm))
    cost = ns.neighbor_search_cost(
        g, s, k, m, real_pairs=sum(r.num_nodes ** 2 for r in raws),
        real_atoms=sum(r.num_nodes for r in raws), filled=filled)
    entry = kernel_entry(
        "neighbor_search", "neighbor_search.cu",
        "cgnn_tpu/ops/neighbor_search.py:136", errs,
        timings(cold(ns.neighbor_search_cuda, *args)),
        time_ms(cold(ns.neighbor_search_reference, *args), calls=5,
                trials=3, warmup=1), cost)
    entry["bound_ms_before"], entry["bound_by_before"] = bound(
        {"bytes": cost["bytes"], "flops": cost["flops_before"]})

    # kernel 1 on the raw path's own graph: N = G*S node slots, padding
    # rows and self-loop slots included, edges from the card's f32 distances
    gb, _, _ = shape_set.raw_expander(device=dev)(rb)
    cargs = conv_inputs(dev, gb)
    k1_errs = compare("fused_cgconv_eval at the top raw rung",
                      fc.fused_cgconv_eval_cuda(*cargs),
                      fc.fused_cgconv_eval_reference(*cargs), RTOL, ATOL)
    n = gb.edges.shape[0]
    _, bound_ms, bound_by, before_ms, before_by = conv_bounds(gb)
    k1_raw = {"N": n, "max_abs_err": k1_errs[0], "max_rel_err": k1_errs[1],
              **timings(cold(fc.fused_cgconv_eval_cuda, *cargs)),
              "plain_ms": time_ms(
                  cold(fc.fused_cgconv_eval_reference, *cargs)),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_ms_before": before_ms, "bound_by_before": before_by}
    print(f"fused_cgconv_eval at the top raw rung (N={n}): {k1_raw['ms']!r} "
          f"ms a call, {k1_raw['plain_ms']!r} ms plain, bound "
          f"{bound_ms!r} ms; kernel 8 max_abs_err {errs[0]!r}, kernel 1 "
          f"max_abs_err {k1_errs[0]!r}")
    return entry, k1_raw


def search_equal(label, args):
    """Kernel 8 twice and its plain version on ``args``: every output
    bit-equal across the three. -> ((max abs, max rel) distance error
    against the plain version, the filled slots)."""
    import torch

    from cgnn_tpu_torch.ops import neighbor_search as ns

    got = ns.neighbor_search_cuda(*args)
    again = ns.neighbor_search_cuda(*args)
    want = ns.neighbor_search_reference(*args)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("neighbors", "distances", "edge_mask",
                              "n_edges"), got, want, again):
        check(torch.equal(a, b), f"{label}: {name} differ from the plain "
                                 f"version's")
        check(torch.equal(a, c), f"{label}: {name} differ from run to run")
    err = (got[1] - want[1]).abs()
    print(f"{label}: neighbors, distances, edge mask and n_edges bit-equal "
          f"to the plain version and on a second run ({int(got[3].sum())} "
          f"edges): ok")
    return ((float(err.max()),
             float((err / want[1].abs().clamp_min(1e-6)).max())),
            int(want[3].sum()))


def serve_phase(dev, calibration, work_dir):
    """The serving path: load_server(wire='raw') at full width, a burst
    of 224 featurized graphs (path 'serve'), then one of 32 wire-form
    structures (path 'serve_raw'), each a run with its own counts; then
    the overflow leg."""
    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    data_cfg = DataConfig()
    os.makedirs(work_dir, exist_ok=True)
    npz = os.path.join(work_dir, "params.npz")
    meta = os.path.join(work_dir, "meta.json")
    variables = convert.init_params(model_cfg, data_cfg, seed=SEED)
    convert.save_params(npz, meta, variables, model_cfg, data_cfg,
                        normalizer_mean=[-1.25], normalizer_std=[0.75])
    t0 = time.perf_counter()
    server, info = load_server(npz, meta, batch_size=64, rungs=3,
                               calibration=calibration, device=dev,
                               default_timeout_ms=60_000.0, wire="raw",
                               cache_size=0)
    spec = server.shape_set.raw
    check(spec is not None, "load_server(wire='raw') planned no raw spec")
    print(f"serve: load_server + warm {time.perf_counter() - t0!r} s; "
          f"rungs {[tuple(vars(s).values()) for s in server.shape_set]}; "
          f"raw spec {spec.to_meta()}")
    graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                               seed=SEED + 1)
    wire = [RawStructure.from_structure(s, cif_id=sid)
            for sid, s, _ in synthetic_mp_dataset(N_WIRE, seed=SEED + 2)]
    n_admitted = sum(spec.admits(r) for r in wire)
    n_conv = model_cfg.n_conv
    per_step = dense_per_step(n_conv)
    # the featurized path's run, then the raw wire's, each with its counts
    runs = {path: burst(server, reqs, path, per_step)
            for path, reqs in (("serve", graphs), ("serve_raw", wire))}
    feat, raw = runs["serve"], runs["serve_raw"]
    check(feat["wires"] == ["featurized"] * len(graphs)
          and feat["raw_flushes"] == 0 and feat["flushes"] > 0,
          f"featurized run: {feat['flushes']} flushes, {feat['raw_flushes']}"
          f" raw: want no raw flush")
    deferred = raw["wires"].count("featurized")
    print(f"serve_raw: {N_WIRE} wire structures ({n_admitted} admitted raw, "
          f"{deferred} featurized on the worker)")
    check(raw["responses_raw"] == n_admitted == raw["wires"].count("raw")
          and deferred == N_WIRE - n_admitted >= 1,
          f"{raw['responses_raw']} raw answers, {deferred} deferred: want "
          f"{n_admitted} raw and at least one deferred")
    check(raw["raw_flushes"] > 0, "the raw burst ran no raw flush")
    requests = graphs + wire
    preds = np.concatenate([feat.pop("preds"), raw.pop("preds")])
    wires = feat.pop("wires") + raw.pop("wires")

    # the same weights through the unfused plain path on the card, on
    # host-featurized copies of the wire structures
    plain = build_model(dataclasses.replace(model_cfg, cgconv_impl=""),
                        data_cfg, device=dev)
    plain.load_state_dict(convert.from_flax_variables(variables))
    state = InferenceState(plain, Normalizer.from_arrays([-1.25], [0.75],
                                                         dev))
    featurize = structure_featurizer(data_cfg)
    ref_graphs = graphs + [featurize(s) for s in wire]
    step = make_predict_step()
    big = server.shape_set.largest
    want, chunk = [], []
    for g in ref_graphs + [None]:
        n = sum(x.num_nodes for x in chunk) + (g.num_nodes if g else 0)
        if chunk and (g is None or not big.fits(len(chunk) + 1, n, n * M)):
            out = step(state, server.shape_set.pack_full(chunk).to(dev))
            want.append(out[:len(chunk)].cpu().numpy())
            chunk = []
        if g is not None:
            chunk.append(g)
    want = np.concatenate(want)
    err = np.abs(preds - want)
    raw_rows = np.array(wires) == "raw"
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"serve: {len(requests)} answers vs the plain path: max_abs_err "
          f"{float(err.max())!r}, raw-wire answers {float(err[raw_rows].max())!r}"
          f" (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "served answers disagree with the plain path")
    summary = dict(runs, deferred_featurized=deferred,
                   max_abs_err_vs_plain=float(err.max()),
                   raw_max_abs_err_vs_plain=float(err[raw_rows].max()))
    summary["overflow_leg"], overflow_counts = overflow_leg(
        dev, npz, meta, calibration, per_step)
    breakdown = flush_breakdown(dev, server.state, server.shape_set,
                                calibration)
    raw_breakdown = raw_flush_breakdown(dev, server, calibration)
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    counts = {"serve": feat.pop("path"), "serve_raw": raw.pop("path"),
              "serve_raw_overflow": overflow_counts}
    return summary, breakdown, raw_breakdown, counts


def burst(server, requests, path=None, per_step=None, width=1, tiers=None,
          runs_a_flush=1, card_exact=True):
    """``requests`` from N_CLIENTS threads at once -> the answers, their
    wire forms and the run's flushes, requests/s and latency quantiles.
    With ``path``: the run is that path's (``PathRun``), every flush one
    replay of its predict graph (``check_path`` against the flushes:
    raw ones ``predict_raw`` steps, the rest ``predict`` steps), and its
    record is under ``path``. ``tiers``: each request's precision tier;
    ``runs_a_flush``: graph runs a flush (a mesh flush runs one a
    shard); ``card_exact``: ``check_path``'s."""
    import contextlib
    import numpy as np

    results = [None] * len(requests)
    errors = []

    def client(k):
        try:
            futs = [(i, server.submit(
                requests[i], precision=None if tiers is None else tiers[i]))
                    for i in range(k, len(requests), N_CLIENTS)]
            for i, fut in futs:
                results[i] = fut.result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"chip-smoke-client-{k}")
               for k in range(N_CLIENTS)]
    c0 = dict(server.counts)
    with (PathRun(path) if path else contextlib.nullcontext()) as run:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a client hung")
    check(not errors, f"client errors: {errors[:3]}")
    check(all(r is not None for r in results), "unanswered requests")
    preds = np.stack([r.prediction for r in results])
    check(preds.shape == (len(requests), width), f"bad shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    delta = {k: server.counts[k] - c0[k]
             for k in ("batches", "pack_raw", "responses_raw")}
    graphs = server.stats()["counts"]
    check(graphs["captures_after_warm"] == 0,
          f"the burst captured a graph after warm-up: {graphs}")
    p50, p99 = np.percentile([r.latency_ms for r in results], [50, 99])
    rec = {"requests": len(requests), "flushes": delta["batches"],
           "raw_flushes": delta["pack_raw"],
           "responses_raw": delta["responses_raw"], "traced": bool(path),
           "wall_s": wall, "requests_per_s": len(requests) / wall,
           "captures_after_warm": graphs["captures_after_warm"],
           "latency_ms_p50": float(p50), "latency_ms_p99": float(p99)}
    print(f"serve burst: {rec}")
    if path:
        rec["path"] = check_path(run, per_step, {
            "predict": runs_a_flush * (rec["flushes"] - rec["raw_flushes"]),
            "predict_raw": runs_a_flush * rec["raw_flushes"]},
            card_exact=card_exact)
    rec.update(preds=preds, wires=[r.wire for r in results],
               precisions=[r.precision for r in results],
               device_ids=[r.device_id for r in results])
    return rec


def overflow_leg(dev, npz, meta, calibration, per_step):
    """A one-atom 2 A cubic cell through a server that skips the host
    image-cap check: the device flags its overflow and it is answered
    through the featurized fallback, equal to its featurized answer."""
    import numpy as np

    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer

    server, info = load_server(npz, meta, batch_size=8, rungs=1,
                               calibration=calibration, device=dev,
                               default_timeout_ms=60_000.0, wire="raw",
                               raw_precheck=False, cache_size=0,
                               log_fn=lambda *a: None)
    tiny = RawStructure(np.zeros((1, 3)), np.eye(3) * 2.0,
                        np.array([6], np.int32))
    try:
        # the overflow path's run: a raw flush, then the featurized one
        # that answers it
        with PathRun("serve_raw_overflow") as run:
            res = server.predict(tiny, timeout_ms=60_000)
        ref = server.predict(structure_featurizer(info["data_cfg"])(tiny),
                             timeout_ms=60_000)
        c = dict(server.counts)
    finally:
        check(server.drain(timeout_s=60), "the serve worker did not drain")
    err = float(np.abs(res.prediction - ref.prediction).max())
    counts = check_path(run, per_step, {"predict_raw": 1, "predict": 1})
    ok = (res.wire == "featurized" and c["ingest_cap_overflow"] == 1
          and c["pack_raw"] == 1 and bool(np.allclose(res.prediction, ref.prediction,
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)))
    print(f"overflow leg: answered via the {res.wire} wire, "
          f"ingest_cap_overflow {c['ingest_cap_overflow']}, max_abs_err vs its featurized answer {err!r}: "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the overflow-flagged structure was not answered through "
              "the featurized fallback")
    return {"wire": res.wire,
            "ingest_cap_overflow": c["ingest_cap_overflow"],
            "max_abs_err_vs_featurized": err}, counts


def flush_breakdown(dev, state, shape_set, graphs, reps=10,
                    kernel_key="fused_cgconv_eval_",
                    kernel_label="fused_kernel"):
    """One top-rung flush of ``graphs`` split into its stages, each the
    median of ``reps``: host pack, host-to-device copy, the predict step
    (host wall with a synchronize), and the copy of the answers back. Then
    the step's device busy time per step, from a torch.profiler trace of
    ``reps`` steps: the sum of its kernels' device time, the share of it
    of the hand-written kernel whose name holds ``kernel_key`` (reported
    as ``<kernel_label>_ms_per_step``), and the share of the step's wall
    the device sits idle."""
    import torch

    from cgnn_tpu_torch.train.step import make_predict_step

    step = make_predict_step()
    top = shape_set.largest
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = shape_set.pack_full(graphs, shape=top)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    res = {"graphs": len(graphs),
           "nodes": sum(g.num_nodes for g in graphs),
           "rung": list(vars(top).values())}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    res["replay"] = replay_breakdown(dev, lambda b: step(state, b), on_dev,
                                     res["step_wall_ms"], reps)
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    if busy_ms is not None:
        ours_ms = sum(v for k, v in by_kernel.items() if kernel_key in k)
        top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        res["step_device_busy_ms"] = busy_ms
        res[f"{kernel_label}_ms_per_step"] = ours_ms
        res[f"{kernel_label}_share_of_busy"] = ours_ms / busy_ms
        res["device_idle_share_of_step"] = 1.0 - busy_ms / res["step_wall_ms"]
        res["top_kernels_ms_per_step"] = {k[:80]: v for k, v in top_k}
    else:  # the profiler saw no device activity on this machine
        res["step_device_busy_ms"] = None
    return res


def replay_breakdown(dev, fn, batch, eager_wall_ms, reps=10,
                     kind="predict"):
    """The step ``fn(batch)`` (``batch`` on the card) as a captured
    StepGraph: the step wall of a replay (the copy into its static inputs
    and the replay, then a synchronize; median of ``reps``) beside the
    eager one, the host's time a replay is queued (``host_us``, no sync),
    and from a profiler trace its device busy time and idle share."""
    import torch

    from cgnn_tpu_torch.train.graphs import StepGraph

    g = StepGraph(fn, batch, device=dev, kind=kind, label="breakdown")
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.run(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    busy, _, _ = device_busy_ms(lambda: g.run(batch), reps)
    return {"replay_step_wall_ms": wall, "eager_step_wall_ms": eager_wall_ms,
            "replay_host_us": host_us(lambda: g.run(batch), calls=50),
            "replay_device_busy_ms": busy,
            "replay_device_idle_share_of_step":
            None if busy is None else 1.0 - busy / wall}


def raw_flush_breakdown(dev, server, graphs, reps=10):
    """One top-rung raw flush of the admitted ``graphs`` in wire form,
    split like ``flush_breakdown``: host pack (``pack_raw``), host-to-
    device copy, the raw predict step (the device search, featurization
    and model; host wall with a synchronize) and the copy of (predictions,
    overflow, n_edges) back; then the step's host syncs and, from a
    torch.profiler trace, its device busy time with kernel 8's and kernel
    1's shares and the share of the step's wall the device sits idle."""
    import torch

    from cgnn_tpu_torch.data.rawbatch import raw_from_graph

    ss, step, state = server.shape_set, server.predict_step, server.state
    raws = [r for r in map(raw_from_graph, graphs) if ss.admits_raw(r)]
    top = ss.largest
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = ss.pack_raw(raws, shape=top)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for t in out:
            t.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    res = {"structures": len(raws),
           "atoms": sum(r.num_nodes for r in raws),
           "rung": list(vars(top).values()),
           "snode_cap": ss.raw.snode_cap, "images": list(ss.raw.images)}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    res.update(host_syncs(lambda: step(state, on_dev)))
    res["replay"] = replay_breakdown(dev, lambda b: step(state, b), on_dev,
                                     res["step_wall_ms"], reps,
                                     kind="predict_raw")
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    if busy_ms is None:  # the profiler saw no device activity
        res["step_device_busy_ms"] = None
        return res
    k8 = sum(v for k, v in by_kernel.items() if "neighbor_search_kernel" in k)
    k1 = sum(v for k, v in by_kernel.items()
             if "fused_cgconv_eval_" in k)
    top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    res.update({
        "step_device_busy_ms": busy_ms,
        "search_kernel_ms_per_step": k8,
        "search_kernel_share_of_busy": k8 / busy_ms,
        "fused_kernel_ms_per_step": k1,
        "fused_kernel_share_of_busy": k1 / busy_ms,
        "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
        "device_kernels": len(by_kernel),
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top_k},
    })
    return res


def device_busy_ms(run_step, reps):
    """A torch.profiler trace of ``reps`` calls of ``run_step`` -> (device
    busy ms per call: the sum of its kernels' device time, {kernel name:
    ms per call}, {host op: self CPU ms per call}); the first is None when
    the trace holds no device time. A trace that came back without any
    device activity (the card's activity records lost, seen now and then
    on this machine) is taken again, up to twice."""
    for _ in range(2):
        out = _device_busy_ms(run_step, reps)
        if out[0] is not None:
            return out
    return _device_busy_ms(run_step, reps)


def _device_busy_ms(run_step, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    by_kernel = {e.key: e.self_device_time_total / reps / 1e3
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    by_host_op = {e.key: e.self_cpu_time_total / reps / 1e3 for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    busy = sum(by_kernel.values())
    return (busy if busy > 0 else None), by_kernel, by_host_op


def device_ms(fn, reps=20) -> float | None:
    """Device time of one call of ``fn`` (all its kernels) from a
    torch.profiler trace of ``reps`` calls after a warm-up: the events
    timing of back-to-back calls (``time_ms``) reads the host instead when
    a call's host work outlasts its kernels. None when the trace holds no
    device time."""
    fn()
    return device_busy_ms(fn, reps)[0]


def host_syncs(run_step) -> dict:
    """The operations of one step (``run_step``, after its host-to-device
    copy) that make the host wait for the device, from CUDA sync debug
    mode: their count and, for each, the innermost line of this repository
    on the Python stack (with the number of syncs there)."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    here = os.path.dirname(os.path.abspath(__file__))
    in_step = []  # non-empty while run_step runs (not the mode switches)

    def record(message, category, filename, lineno, file=None, line=None):
        if not in_step or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if os.path.abspath(f.filename)
                .startswith(here) and "site-packages" not in f.filename]
        f = (ours or stack)[-1]
        sites[f"{os.path.relpath(f.filename, here)}:{f.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_step.append(True)
            run_step()
        finally:
            in_step.clear()
            torch.cuda.set_sync_debug_mode("default")
    return {"host_syncs_per_step": sum(sites.values()),
            "host_sync_sites": dict(sites)}


def new_state(dev, train_graphs, **model_kw):
    """A fresh flagship TrainState (seed SEED, train.py's SGD defaults),
    dense unless ``model_kw`` sets ``dense_m=0`` -> (config, state,
    node_cap, edge_cap)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.state import init_train_state

    cfg = ModelConfig(**({"dense_m": M} | model_kw))
    state, node_cap, edge_cap = init_train_state(
        cfg, DataConfig(), train_graphs, batch_size=BATCH, device=dev,
        seed=SEED)
    return cfg, state, node_cap, edge_cap


def train_phase(dev, split, work_dir):
    """The training path: the port's fit, kernel path, 2 epochs; then the
    trained weights through load_server."""
    import math

    import numpy as np
    import torch

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    train_g, val_g, test_g = split
    cfg, state, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
    steps, evals = (EPOCHS * count_batches(g, BATCH, node_cap, node_cap * M,
                                           snug=True)
                    for g in (train_g, val_g))
    # the training path's run
    with PathRun("train_cgconv_pallas") as run:
        t0 = time.perf_counter()
        state, result = fit(state, train_g, val_g, epochs=EPOCHS,
                            batch_size=BATCH, dense_m=M, device=dev,
                            node_cap=node_cap, seed=SEED,
                            log_fn=lambda s: print(f"train: {s}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hist = result["history"]
    n_conv = cfg.n_conv
    print(f"train: {steps} train steps, {evals} eval batches, graphs "
          f"{result['graphs']}")
    check(sum(h["train"]["steps"] for h in hist) == steps
          and sum(h["val"]["steps"] for h in hist) == evals
          and result["graphs"]["captures_after_warm"] == 0,
          f"train: history steps, graphs {result['graphs']}")
    # every step one run of its shape's graph; in a train step the
    # forward runs one node pass a conv, shared by kernels 1 and 2
    counts = check_path(run, dense_per_step(n_conv),
                        {"train": steps, "eval": evals})
    for h in hist:
        vals = (h["train"]["loss"], h["train"]["mae"], h["val"]["mae"])
        check(all(math.isfinite(v) for v in vals),
              f"epoch {h['epoch']}: non-finite loss or MAE {vals}")

    # the trained weights, served
    out_dir = os.path.join(work_dir, "trained")
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, "params.npz")
    meta = os.path.join(out_dir, "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()), cfg,
        DataConfig(), normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    server, _ = load_server(npz, meta, batch_size=8, rungs=1,
                            calibration=test_g, device=dev,
                            default_timeout_ms=60_000.0,
                            log_fn=lambda *a: None)
    asked = test_g[:8]
    try:
        futs = [server.submit(g) for g in asked]
        preds = np.stack([f.result(timeout=120).prediction for f in futs])
    finally:
        check(server.drain(timeout_s=60), "the serve worker did not drain")
    state.model.eval()
    predict, inf = make_predict_step(), InferenceState(state.model,
                                                       state.normalizer)
    want = np.concatenate([
        predict(inf, server.shape_set.pack_full([g]).to(dev))[:1].cpu()
        .numpy() for g in asked])
    err = float(np.abs(preds - want).max())
    ok = preds.shape == (8, 1) and bool(np.isfinite(preds).all()) and bool(
        np.all(np.abs(preds - want) <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"train: the trained weights served 8 requests, max_abs_err "
          f"{err!r} vs the trained model (rtol {SERVE_RTOL}, atol "
          f"{SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "the trained weights do not serve the trained model's answers")
    fit_graphs = len(train_g) * EPOCHS
    summary = {
        "structures": [len(train_g), len(val_g), len(test_g)],
        "batch_size": BATCH, "epochs": EPOCHS, "node_cap": node_cap,
        "train_steps": steps, "eval_batches": evals,
        "launches": counts["launches"], "fit_wall_s": wall,
        "fit_structures_per_s_incl_val_and_warmup": fit_graphs / wall,
        "train_loss": [h["train"]["loss"] for h in hist],
        "train_mae": [h["train"]["mae"] for h in hist],
        "val_mae": [h["val"]["mae"] for h in hist],
        "served_max_abs_err_vs_trained": err,
    }
    return summary, counts, node_cap


def fixed_batches(dev, train_g, node_cap, k, edge_cap=None, dense_m=M,
                  edge_dtype=None):
    """The first ``k`` shuffled snug training batches (epochs in turn, one
    seeded generator), on the card; ``dense_m=None``: COO batches of
    ``edge_cap`` edges; ``edge_dtype``: the edges' storage type (a bf16
    model's batches carry bf16 edges)."""
    import numpy as np

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.loop import edge_pack_fn

    rng = np.random.default_rng(SEED + 5)
    edge_cap = node_cap * dense_m if dense_m else edge_cap
    pack_fn = None if edge_dtype is None else edge_pack_fn(edge_dtype)
    out = []
    while len(out) < k:
        out += list(batch_iterator(train_g, BATCH, node_cap, edge_cap,
                                   shuffle=True, rng=rng, dense_m=dense_m,
                                   snug=True, pack_fn=pack_fn))
    return [b.to(dev) for b in out[:k]]


def compare_trajectories(dev, train_g, batches, label, kernel_kw, plain_kw,
                         rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    """The same steps on ``batches`` from the same initial weights through
    the kernel path (``kernel_kw``) and the plain path (``plain_kw``):
    per-step loss and every parameter and running statistic within
    ``rtol`` / ``atol`` (default TRAIN_RTOL / TRAIN_ATOL; ``rtol`` of the
    tensor's largest |entry| where ``rtol`` is BF16_TOL, the bf16
    comparison) -> (the plain losses, {max diffs})."""
    import torch

    from cgnn_tpu_torch.train.step import make_train_step

    runs = []
    for kw in (kernel_kw, plain_kw):
        _, state, _, _ = new_state(dev, train_g, **kw)
        step = make_train_step()
        losses = [m["loss_sum"] / m["count"]
                  for m in (step(state, b) for b in batches)]
        runs.append((torch.stack(losses).cpu(),
                     {key: v.detach().clone()
                      for key, v in state.model.state_dict().items()}))
    (loss_k, sd_k), (loss_p, sd_p) = runs

    def close(a, b):
        if rtol == BF16_TOL:  # of the tensor's largest |entry|
            return bool(((a - b).abs() <= rtol * b.abs().max() + atol).all())
        return bool(torch.allclose(a, b, rtol=rtol, atol=atol))

    loss_err = float((loss_k - loss_p).abs().max())
    ok = close(loss_k, loss_p)
    param_err, worst = 0.0, ""
    for key in sd_p:
        e = float((sd_k[key] - sd_p[key]).abs().max())
        if e > param_err:
            param_err, worst = e, key
        ok = ok and close(sd_k[key].float(), sd_p[key].float())
    print(f"{label}: {len(batches)} steps, kernel path vs plain path: "
          f"losses {loss_k.tolist()} vs {loss_p.tolist()}, max loss diff "
          f"{loss_err!r}, max parameter diff {param_err!r} ({worst}) "
          f"(rtol {rtol}, atol {atol}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the kernel path's trajectory leaves the plain "
              f"path's")
    return loss_p, {"steps": len(batches), "max_loss_diff": loss_err,
                    "max_param_diff": param_err, "worst_param": worst}


def trajectory_phase(dev, train_g, val_g, node_cap, k=5):
    """The same k steps through the kernel path and the plain path; then 3
    steps and one eval batch with fused_epilogue='pallas'."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

    batches = fixed_batches(dev, train_g, node_cap, k)
    loss_p, diffs = compare_trajectories(
        dev, train_g, batches, "trajectory", {"cgconv_impl": "pallas"},
        {"cgconv_impl": ""})

    cfg, state, _, _ = new_state(dev, train_g, fused_epilogue="pallas")
    val_batch = next(iter(batch_iterator(
        val_g, BATCH, node_cap, node_cap * M, dense_m=M, in_cap=0,
        snug=True))).to(dev)
    train_step, eval_step = make_train_step(), make_eval_step()
    # the fused-epilogue path's run: 3 train steps and an eval batch,
    # stepped directly
    with PathRun("train_fused_epilogue_pallas") as run:
        losses = [m["loss_sum"] / m["count"]
                  for m in (train_step(state, b) for b in batches[:3])]
        ev = eval_step(state, val_batch)
    counts = check_path(run, dense_per_step(cfg.n_conv, epilogue=True), {},
                        outside={"train": 3, "eval": 1})
    losses = torch.stack(losses).cpu()
    e_err = float((losses - loss_p[:3]).abs().max())
    ok = (bool(torch.isfinite(ev["mae_sum"]))
          and bool(torch.allclose(losses, loss_p[:3], rtol=TRAIN_RTOL,
                                  atol=TRAIN_ATOL)))
    print(f"epilogue: 3 steps + 1 eval batch with fused_epilogue='pallas': "
          f"losses {losses.tolist()}, max "
          f"diff vs the plain path {e_err!r}: {'ok' if ok else 'FAIL'}")
    check(ok, "the fused-epilogue path did not run its kernels or "
              "disagrees with the plain path")
    return diffs | {"epilogue_max_loss_diff": e_err}, counts


def train_breakdown(dev, train_g, label, steps=8, **model_kw):
    """The per-step training loop of one setting at the training shape
    (its layout's snug capacities): train structures/s as the loop runs
    (host pack, copy and the step's launches in turn, no extra
    synchronize), then each stage alone (median of ``steps``,
    synchronized), then the step's device busy time and idle share from a
    torch.profiler trace."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_train_step

    cfg, state, node_cap, edge_cap = new_state(dev, train_g, **model_kw)
    step = make_train_step()
    rng = np.random.default_rng(SEED + 7)

    def host_batches():
        while True:
            yield from batch_iterator(train_g, BATCH, node_cap, edge_cap,
                                      shuffle=True, rng=rng,
                                      dense_m=cfg.dense_m or None, snug=True)

    it = host_batches()
    for _ in range(2):  # warm-up
        step(state, next(it).to(dev))
    torch.cuda.synchronize()
    graphs = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = next(it)
        graphs += int(batch.graph_mask.sum())
        step(state, batch.to(dev))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    res = {"path": label, "steps": steps,
           "structures_per_step": graphs / steps,
           "train_structures_per_s": graphs / loop_s,
           "loop_ms_per_step": loop_s * 1e3 / steps}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    on_dev = next(it).to(dev)
    res.update(host_syncs(lambda: step(state, on_dev)))
    on_dev = [next(it).to(dev) for _ in range(steps)]
    queue = iter(on_dev)
    busy_ms, by_kernel, by_host_op = device_busy_ms(
        lambda: step(state, next(queue)), steps)
    if busy_ms is None:  # the profiler saw no device activity
        res["step_device_busy_ms"] = None
        return res
    ours = ("fused_cgconv", "epilogue_", "sum_partials", "segment_sum")
    ours_ms = sum(v for k, v in by_kernel.items()
                  if any(o in k for o in ours))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    top_host = sorted(by_host_op.items(), key=lambda kv: -kv[1])[:8]
    res.update({
        "step_device_busy_ms": busy_ms,
        "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
        "device_idle_share_of_loop": 1.0 - busy_ms / res["loop_ms_per_step"],
        "hand_kernels_ms_per_step": ours_ms,
        "hand_kernels_share_of_busy": ours_ms / busy_ms,
        "device_kernels": len(by_kernel),
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top},
        "host_ms_per_step": sum(by_host_op.values()),
        "top_host_ops_ms_per_step": {k[:60]: v for k, v in top_host},
    })
    return res


def segment_sum_check(dev, label, batch, seed, hub=None):
    """Kernel 6 on one packed COO batch: seeded [E, 64] messages zeroed on
    the padding edges, against its plain version (rtol/atol), bit-identical
    on a second run; then timed beside its plain version and the library
    call ``torch.segment_reduce`` on the same offsets. ``hub``: a real node
    takes the padding edges instead of node N-1 (the centers re-sorted,
    the messages with them, and not zeroed there). -> its record."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.ops import scatter

    e, f = batch.edge_mask.shape[0], 64
    n = batch.nodes.shape[0]
    rng = np.random.default_rng(seed)
    msgs = rng.standard_normal((e, f))
    centers = batch.centers.numpy()
    if hub is None:
        msgs = msgs * batch.edge_mask.numpy()[:, None]
    else:
        centers = np.where(batch.edge_mask.numpy() > 0, centers, hub)
        order = np.argsort(centers, kind="stable")
        centers, msgs = centers[order], msgs[order]
    msgs = torch.from_numpy(msgs.astype(np.float32)).to(dev)
    centers = torch.from_numpy(centers.astype(np.int32)).to(dev)
    offsets = scatter.segment_offsets(centers, n)
    got = scatter.segment_sum_sorted_cuda(msgs, offsets)
    again = scatter.segment_sum_sorted_cuda(msgs, offsets)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: kernel 6 differs from run to "
                                   f"run")
    errs = compare(f"segment_sum_sorted, {label}", got,
                   scatter.segment_sum_sorted_reference(msgs, offsets),
                   RTOL, ATOL)
    real = int(batch.edge_mask.sum())
    spans = np.diff(offsets.cpu().numpy())
    cost = scatter.segment_sum_cost(e, n, f)
    bound_ms, bound_by = bound(cost)
    big = int(np.argmax(spans))
    rec = {"E": e, "N": n, "F": f, "real_edges": real,
           "longest_node": big, "longest_node_edges": int(spans[big]),
           "node_n_minus_1_edges": int(spans[-1]),
           "max_abs_err": errs[0], "max_rel_err": errs[1],
           **timings(cold(scatter.segment_sum_sorted_cuda, msgs, offsets),
                     cold(lambda x, o: torch.segment_reduce(
                         x, "sum", offsets=o, axis=0, unsafe=True),
                          msgs, offsets)),
           "plain_ms": time_ms(
               cold(scatter.segment_sum_sorted_reference, msgs, offsets)),
           "bound_ms": bound_ms, "bound_by": bound_by, "cost": cost}
    print(f"segment_sum_sorted, {label}: {rec}")
    return rec


def coo_kernel_phase(dev, train_graphs, calibration):
    """Kernel 6 at the COO training shape, at the top COO serving rung and
    at the training shape with its padding edges on a real node in the
    middle (N/2); kernel 7 at the dense training shape. -> their two
    entries."""
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    node_cap, edge_cap = capacities_for(train_graphs, BATCH)
    train_batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                           edge_cap, snug=True)))
    train = segment_sum_check(dev, "COO training shape", train_batch, SEED)
    ss = plan_shape_set(calibration, 64, rungs=3)
    serve = segment_sum_check(dev, "top COO serving rung",
                              ss.pack_full(calibration, shape=ss.largest),
                              SEED + 1)
    mid = train_batch.nodes.shape[0] // 2
    hub = segment_sum_check(dev, f"COO training shape, hub at node {mid}",
                            train_batch, SEED, hub=mid)
    k6 = kernel_entry(
        "segment_sum_sorted", "segment_sum.cu",
        "cgnn_tpu/ops/pallas_scatter.py:52",
        (train["max_abs_err"], train["max_rel_err"]), train,
        train["plain_ms"], train.pop("cost"),
        library_call="torch.segment_reduce(messages, 'sum', offsets=offsets, "
                     "axis=0, unsafe=True)")
    serve.pop("cost")
    hub.pop("cost")
    k6.update(training_shape=train, serve_top_rung=serve,
              training_shape_hub_mid=hub)
    k6["coo_rungs"] = [list(vars(s).values()) for s in ss]
    return k6, gather_kernel_phase(dev, train_graphs)


def gather_kernel_phase(dev, train_graphs):
    """Kernel 7 on the dense training batch packed at the node capacity
    rounded up to 128 (N=7,936): bit-equal to its plain version and to
    ``index_select`` (every neighbor lies in its window on a real graph);
    on shuffled indices, out-of-window slots give zeros, bit-equal to the
    plain version. Then timed beside both. -> its entry, with the
    launches of these checks."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import windowed_gather as wg

    node_cap, _ = capacities_for(train_graphs, BATCH, dense_m=M)
    n = -(-node_cap // wg.TN) * wg.TN
    batch = next(iter(batch_iterator(train_graphs, BATCH, n, n * M,
                                     dense_m=M, in_cap=0, snug=True)))
    f = 64
    window = wg.window_width(max(g.num_nodes for g in train_graphs))
    rng = np.random.default_rng(SEED + 2)
    nodes = torch.from_numpy(
        rng.standard_normal((n, f)).astype(np.float32)).to(dev)
    nbr = batch.neighbors.to(dev)
    ws = torch.from_numpy(wg.window_starts(n // wg.TN, n, window)).to(dev)
    before = wg.windowed_gather_cuda.launches
    got = wg.windowed_gather_cuda(nodes, nbr, ws, window)
    want = wg.windowed_gather_reference(nodes, nbr, ws, window)
    lib = nodes.index_select(0, nbr).reshape(n, M, f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "kernel 7 differs from its plain version")
    check(torch.equal(got, lib), "kernel 7 differs from index_select on a "
                                 "real graph")
    shuffled = nbr[torch.randperm(nbr.numel(), device=dev,
                                  generator=torch.Generator(dev)
                                  .manual_seed(SEED))].contiguous()
    got_s = wg.windowed_gather_cuda(nodes, shuffled, ws, window)
    want_s = wg.windowed_gather_reference(nodes, shuffled, ws, window)
    torch.cuda.synchronize()
    zero_rows = int((got_s == 0).all(dim=-1).sum())
    check(torch.equal(got_s, want_s) and zero_rows > 0,
          f"kernel 7 on shuffled indices: {zero_rows} zero rows, or it "
          f"differs from its plain version")
    launches = wg.windowed_gather_cuda.launches - before
    print(f"windowed_gather at N={n} M={M} F={f}, window {window}: bit-equal "
          f"to its plain version and to index_select; shuffled indices: "
          f"{zero_rows} of {shuffled.numel()} slots out of window, zeros, "
          f"bit-equal: ok")
    entry = kernel_entry(
        "windowed_gather", "windowed_gather.cu",
        "cgnn_tpu/ops/pallas_gather.py:55", (0.0, 0.0),
        timings(cold(wg.windowed_gather_cuda, nodes, nbr, ws, window),
                cold(lambda x, i: x.index_select(0, i), nodes, nbr)),
        time_ms(cold(wg.windowed_gather_reference, nodes, nbr, ws, window)),
        wg.windowed_gather_cost(n, M, f),
        library_call="nodes.index_select(0, neighbors)")
    entry.update(path_note=NO_PATH["windowed_gather"],
                 kernel_phase_launches=launches,
                 shape={"N": n, "M": M, "F": f, "window": window,
                        "out_of_window_slots_shuffled": zero_rows})
    return entry


def train_coo_phase(dev, split, work_dir, k=5):
    """Path 'train_coo': fit at full width in the COO layout with
    aggregation='pallas' (kernel 6), 2 epochs; a k-step trajectory against
    aggregation='xla'; the weights saved. -> (summary, counts, weights)."""
    import math

    import torch

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    cfg, state, node_cap, edge_cap = new_state(dev, train_g, dense_m=0,
                                               aggregation=COO_AGG)
    steps, evals = (EPOCHS * count_batches(g, BATCH, node_cap, edge_cap,
                                           snug=True)
                    for g in (train_g, val_g))
    # the COO training path's run
    with PathRun("train_coo") as run:
        t0 = time.perf_counter()
        state, result = fit(state, train_g, val_g, epochs=EPOCHS,
                            batch_size=BATCH, dense_m=0, device=dev,
                            node_cap=node_cap, edge_cap=edge_cap, seed=SEED,
                            log_fn=lambda s: print(f"train_coo: {s}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hist = result["history"]
    print(f"train_coo: caps N={node_cap} E={edge_cap}, {steps} train steps, "
          f"{evals} eval batches")
    check(result["graphs"]["captures_after_warm"] == 0,
          f"train_coo graphs {result['graphs']}")
    counts = check_path(run, coo_per_step(cfg.n_conv),
                        {"train": steps, "eval": evals})
    for h in hist:
        vals = (h["train"]["loss"], h["train"]["mae"], h["val"]["mae"])
        check(all(math.isfinite(v) for v in vals),
              f"train_coo epoch {h['epoch']}: non-finite loss or MAE {vals}")
    out_dir = os.path.join(work_dir, "trained_coo")
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, "params.npz")
    meta = os.path.join(out_dir, "meta.json")
    variables = convert.to_flax_variables(state.model.state_dict())
    convert.save_params(
        npz, meta, variables, cfg, DataConfig(),
        normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    batches = fixed_batches(dev, train_g, node_cap, k, edge_cap=edge_cap,
                            dense_m=None)
    _, traj = compare_trajectories(
        dev, train_g, batches, "trajectory_coo",
        {"dense_m": 0, "aggregation": COO_AGG},
        {"dense_m": 0, "aggregation": "xla"})
    summary = {
        "node_cap": node_cap, "edge_cap": edge_cap, "train_steps": steps,
        "eval_batches": evals, "launches": counts["launches"],
        "fit_wall_s": wall,
        "fit_structures_per_s_incl_val_and_warmup":
            len(train_g) * EPOCHS / wall,
        "train_loss": [h["train"]["loss"] for h in hist],
        "val_mae": [h["val"]["mae"] for h in hist], "trajectory": traj}
    return summary, counts, (npz, meta, variables, cfg)


def serve_coo_phase(dev, calibration, weights):
    """Path 'serve_coo': load_server on the COO weights (wire='auto' must
    log featurized-only), a burst of 224 featurized graphs and 32
    RawStructures featurized at admission from 4 threads; every answer
    against the plain model (aggregation='xla') on host-featurized copies;
    kernel 6 n_conv times a flush; a top-rung flush breakdown."""
    import dataclasses as dc

    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    npz, meta, variables, cfg = weights
    data_cfg = DataConfig()
    logs = []
    server, _ = load_server(npz, meta, batch_size=64, rungs=3,
                            calibration=calibration, device=dev,
                            default_timeout_ms=60_000.0, wire="auto",
                            cache_size=0,
                            log_fn=lambda s: (logs.append(s), print(s)))
    ss = server.shape_set
    check(ss.dense_m is None and ss.raw is None
          and any("raw wire requires the dense layout; featurized wire only"
                  in s for s in logs),
          f"load_server on COO weights: dense_m {ss.dense_m}, raw "
          f"{ss.raw}, log {logs}")
    graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                               seed=SEED + 1)
    wire = [RawStructure.from_structure(s, cif_id=sid)
            for sid, s, _ in synthetic_mp_dataset(N_WIRE, seed=SEED + 2)]
    run = burst(server, graphs + wire, "serve_coo", coo_per_step(cfg.n_conv))
    preds, wires = run.pop("preds"), run.pop("wires")
    check(run["flushes"] > 0 and wires == ["featurized"] * len(wires),
          f"serve_coo: {run['flushes']} flushes, wires {set(wires)}")
    plain = build_model(dc.replace(cfg, aggregation="xla"), data_cfg,
                        device=dev)
    plain.load_state_dict(convert.from_flax_variables(variables))
    state = InferenceState(plain, server.state.normalizer)
    featurize = structure_featurizer(data_cfg)
    ref = graphs + [featurize(s) for s in wire]
    step = make_predict_step()
    want, chunk = [], []
    for g in ref + [None]:
        fits = g is not None and ss.largest.fits(
            len(chunk) + 1, sum(x.num_nodes for x in chunk) + g.num_nodes,
            sum(x.num_edges for x in chunk) + g.num_edges)
        if chunk and not fits:
            out = step(state, ss.pack_full(chunk).to(dev))
            want.append(out[:len(chunk)].cpu().numpy())
            chunk = []
        if g is not None:
            chunk.append(g)
    want = np.concatenate(want)
    err = np.abs(preds - want)
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"serve_coo: {len(ref)} answers vs the plain model: max_abs_err "
          f"{float(err.max())!r} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "serve_coo answers disagree with the plain model")
    breakdown = flush_breakdown(dev, server.state, ss, calibration,
                                kernel_key="segment_sum_sorted_kernel",
                                kernel_label="segment_sum_kernel")
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    run.update(rungs=[list(vars(s).values()) for s in ss],
               max_abs_err_vs_plain=float(err.max()))
    path = run.pop("path")
    return run, breakdown, path


def run_main(entry, argv, label):
    """``entry(argv)`` (a port entry point's ``main``) with its standard
    output captured and echoed -> (exit code, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"{label}: {line}")
    return rc, out


def state_bits(state) -> dict:
    """Every tensor a TrainState carries, as host copies: parameters and
    running statistics, the optimizer's buffers by parameter name, and
    its count."""
    import torch

    bits = {f"model/{k}": v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.inner.state.get(p, {}).items():
            bits[f"opt/{name}/{k}"] = torch.as_tensor(v).detach().cpu().clone()
    bits["opt/count"] = torch.as_tensor(state.optimizer.count)
    return bits


def bits_diff(a: dict, b: dict) -> tuple[bool, float, str]:
    """(bit-equal, max abs difference, the key where it is largest)."""
    import torch

    check(set(a) == set(b), f"state keys differ: {set(a) ^ set(b)}")
    equal, worst, where = True, 0.0, ""
    for k in a:
        if not torch.equal(a[k], b[k]):
            equal = False
            d = float((a[k].double() - b[k].double()).abs().max())
            if d >= worst:
                worst, where = d, k
    return equal, worst, where


def predict_path(run, per_step, info) -> dict:
    """Bulk predict's path run against its batches: each one run of its
    shape's predict graph (a shape's first two batches eager, the third
    captured)."""
    return check_path(run, per_step,
                      {"predict": info["batches_featurized"],
                       "predict_raw": info["batches_raw"]})


def checkpoint_predict_phase(dev, work_dir, card):
    """Paths 'train_main', 'predict' and 'predict_raw': the port's train
    entry point at flagship width with the kernel path commits a
    checkpoint a epoch (manifests verified, the best pointer on the
    better save); a state saved by ``CheckpointManager`` restores
    bit-equal; a resumed epoch equals the uninterrupted one; ``--resume``
    continues the entry point's numbering; bulk predict on both wires
    agrees with the plain model. -> (summary, counts by path)."""
    import copy
    import csv as csvmod
    import dataclasses as dc
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.resilience.integrity import read_manifest, verify_tree
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_tree,
    )
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import InferenceState

    data_cfg = DataConfig()
    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    n_conv = model_cfg.n_conv
    # the entry point's data and split, for the in-memory run below
    graphs = load_synthetic(N_TRAIN_SET, data_cfg.featurize_config(),
                            seed=SEED)
    train_g, val_g, test_g = train_val_test_split(graphs, 0.8, 0.1,
                                                  seed=SEED)

    def fresh():
        return init_train_state(model_cfg, data_cfg, train_g,
                                batch_size=BATCH, device=dev, seed=SEED)

    _, node_cap, edge_cap = fresh()
    steps, evals = (count_batches(g, BATCH, node_cap, edge_cap, snug=True)
                    for g in (train_g, val_g))
    tests = count_batches(test_g, BATCH, node_cap, edge_cap, snug=True)
    ck, own = (os.path.join(work_dir, d) for d in ("ckpt", "ckpt_own"))
    for d in (ck, own, os.path.join(work_dir, "ckpt_out")):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--synthetic", str(N_TRAIN_SET), "-b", str(BATCH),
            "--cgconv-impl", "pallas", "--ckpt-dir", ck, "--out-dir",
            os.path.join(work_dir, "ckpt_out"), "--print-freq", "0",
            "--seed", str(SEED)]
    counts = {}
    per_step = dense_per_step(n_conv)
    # 1. the train entry point, 2 epochs: 2 committed saves
    with PathRun("train_main") as run:
        rc, out = run_main(train_main, argv + ["--epochs", "2"],
                           "train_main")
    check(rc == 0, f"train entry point exited {rc}")
    mgr = CheckpointManager(ck, log_fn=print)
    saves = sorted(n for n in os.listdir(ck) if n.startswith("ckpt-"))
    check(saves == ["ckpt-00000000", "ckpt-00000001"],
          f"2 epochs committed {saves}")
    maes = []
    for name in saves:
        verify_tree(load_tree(os.path.join(ck, name, STATE_FILE)),
                    read_manifest(os.path.join(ck, name)))
        maes.append(json.load(open(os.path.join(ck, name,
                                                "meta.json")))["best_mae"])
    best = json.load(open(os.path.join(ck, "best.json")))["save"]
    check(best == saves[int(maes[1] < maes[0])],
          f"best.json points at {best}; val MAEs {maes}")
    # 2 epochs of train steps and validation batches, then the test
    # split (eager)
    counts["train_main"] = check_path(
        run, per_step, {"train": 2 * steps, "eval": 2 * evals + tests})
    print(f"checkpoint: {saves} verified against their manifests, val MAEs "
          f"{maes}, best.json -> {best}: ok")

    # 2. the same run in memory, saved by its own manager every epoch;
    # the restore of its latest save is bit-equal to it
    state = fresh()[0]
    kw = dict(batch_size=BATCH, dense_m=M, device=dev, node_cap=node_cap,
              edge_cap=edge_cap, seed=SEED, log_fn=lambda s: None)
    own_mgr = CheckpointManager(own, log_fn=print)
    save_ms = []

    def save(s, epoch, val_m, is_best):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own_mgr.save(s, {"epoch": epoch, "best_mae": val_m["mae"]},
                     is_best=is_best)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    state, _ = fit(state, train_g, val_g, epochs=2, on_epoch_end=save, **kw)
    torch.cuda.synchronize()
    saved = state_bits(state)
    # the fresh state is built, and the finalizer's writes drained,
    # outside the timed window: restore_ms is the load, verification and
    # copies alone; finalize_wait_ms is what the async writes had left
    target = fresh()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own_mgr.wait()
    finalize_wait_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restored, meta = own_mgr.restore(target)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    equal, worst, where = bits_diff(state_bits(restored), saved)
    check(equal and meta["epoch"] == 1,
          f"restore differs from the saved state: {worst!r} at {where}")
    main_equal, main_diff, main_where = bits_diff(
        state_bits(mgr.restore(fresh()[0])[0]), saved)
    print(f"checkpoint: {len(saved)} tensors restored bit-equal (count "
          f"{int(saved['opt/count'])}); save caller-thread ms {save_ms}, "
          f"finalizer drain ms {finalize_wait_ms!r}, restore ms "
          f"{restore_ms!r}; the entry point's save vs this "
          f"run: bit-equal {main_equal} (max diff {main_diff!r} at "
          f"{main_where or '-'}): ok")

    # 3. one more epoch from the restored state and from the in-memory
    # one, start_epoch=2, the same seed
    def epoch2(s):
        s, r = fit(s, train_g, val_g, epochs=3, start_epoch=2, **kw)
        h = r["history"][0]
        return state_bits(s), (h["train"]["loss"], h["val"]["mae"])

    again = copy.deepcopy(state)
    mem_bits, mem_loss = epoch2(state)
    res_bits, res_loss = epoch2(restored)
    equal, worst, where = bits_diff(res_bits, mem_bits)
    resumed = {"bit_equal": equal and res_loss == mem_loss,
               "losses": [mem_loss, res_loss], "max_diff": worst,
               "worst": where}
    if not resumed["bit_equal"]:
        # the same epoch from a copy of the in-memory state: does it
        # repeat its own bits? Then again with PyTorch's deterministic
        # algorithms (the graph pooling sums in a fixed order; an op
        # PyTorch runs in no fixed order would show here)
        # (segment_sum of the graph pooling, ops/segment.py) by an
        # ordered sum
        rerun_bits, _ = epoch2(copy.deepcopy(again))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = [epoch2(copy.deepcopy(again))[0],
                   epoch2(own_mgr.restore(fresh()[0])[0])[0]]
        finally:
            torch.use_deterministic_algorithms(False)
        resumed.update(
            in_memory_repeats_its_bits=bits_diff(rerun_bits, mem_bits)[0],
            bit_equal_with_deterministic_algorithms=bits_diff(*det)[0],
            op=NONDET_OP)
        ok = all(torch.allclose(res_bits[k].double(), mem_bits[k].double(),
                                rtol=RESUME_RTOL, atol=RESUME_ATOL)
                 for k in mem_bits)
        check(ok and resumed["bit_equal_with_deterministic_algorithms"]
              and not resumed["in_memory_repeats_its_bits"],
              f"the resumed epoch leaves the uninterrupted one: {resumed}")
    print(f"resume: epoch 2 from the restored state vs the in-memory one: "
          f"{resumed}: ok")

    # 4. --resume continues the entry point's run: one epoch
    with PathRun("train_main_resume") as run:
        rc, out = run_main(train_main, argv + ["--epochs", "3", "--resume",
                                               ck], "train_main")
    check(rc == 0 and f"resumed from {ck} at epoch 2" in out
          and "Epoch 2:" in out and "Epoch 0:" not in out,
          f"--resume: rc {rc}, output {out[-400:]!r}")
    counts["train_main_resume"] = check_path(
        run, per_step, {"train": steps, "eval": evals + tests})

    # 5. bulk predict on both wires vs the plain model
    plain = InferenceState(
        build_model(dc.replace(model_cfg, cgconv_impl=""), data_cfg,
                    device=dev),
        Normalizer.identity(1, device=dev))
    plain = mgr.restore_for_inference(plain, "latest")
    pred_graphs = load_synthetic(N_PREDICT, data_cfg.featurize_config())
    want, _ = run_fast_inference(
        plain, pred_graphs, BATCH,
        shape_set=plan_shape_set(pred_graphs, BATCH, rungs=2, dense_m=M))
    runs = {}
    # each wire's path run (traced), then the same run PREDICT_REPEATS
    # times untraced, for its rate (a run lasts tens of ms: the host's
    # spread shows in a single one)
    for path, wire in (("predict_raw", "raw"), ("predict", "featurized")):
        out_csv = os.path.join(work_dir, f"{path}.csv")
        argv_p = [ck, "--synthetic", str(N_PREDICT), "-b", str(BATCH),
                  "--wire", wire, "--out", out_csv]
        with PathRun(path) as run:
            rc, out = run_main(predict_main, argv_p, path)
        check(rc == 0, f"predict --wire {wire} exited {rc}")
        info = json.loads(next(line for line in out.splitlines()
                               if line.startswith("predict: "))[9:])
        counts[path] = predict_path(run, per_step, info)
        rates = []
        for _ in range(PREDICT_REPEATS):
            rc, again = run_main(predict_main, argv_p, path)
            check(rc == 0, f"predict --wire {wire} exited {rc}")
            rates.append(json.loads(next(
                line for line in again.splitlines()
                if line.startswith("predict: "))[9:])["structures_per_s"])
        info.update(traced_structures_per_s=info["structures_per_s"],
                    structures_per_s=statistics.median(rates),
                    structures_per_s_repeats=rates)
        rows = list(csvmod.reader(open(out_csv)))
        got = np.array([[float(x) for x in r[2:]] for r in rows])
        ids_ok = [r[0] for r in rows] == [g.cif_id for g in pred_graphs]
        err = np.abs(got - want)
        ok = ids_ok and got.shape == want.shape and bool(
            np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
        batches = info["batches_raw"] + info["batches_featurized"]
        print(f"{path}: {N_PREDICT} structures ({info['raw']} on the raw "
              f"wire), {batches} batches; CSV ids in input order {ids_ok}, "
              f"max_abs_err vs the plain model {float(err.max())!r} (rtol "
              f"{SERVE_RTOL}, atol {SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
        check(ok, f"{path}: the CSV disagrees with the plain model")
        check(batches > 0 and (wire == "featurized"
                               or info["batches_raw"] > 0),
              f"{path}: {batches} batches, {info['batches_raw']} raw")
        runs[path] = dict(info, max_abs_err_vs_plain=float(err.max()))
    mgr.close()
    own_mgr.close()
    summary = {
        "card": card, "saves": saves, "val_mae": maes, "best": best,
        "save_caller_thread_ms": save_ms,
        "finalize_wait_ms": finalize_wait_ms, "restore_ms": restore_ms,
        "restored_tensors": len(saved),
        "entry_point_save_bit_equal_to_in_memory_run": main_equal,
        "resumed_epoch": resumed,
        "predict_structures_per_s": {
            w: runs[p]["structures_per_s"]
            for p, w in (("predict", "featurized"), ("predict_raw", "raw"))},
        "predict": runs["predict"], "predict_raw": runs["predict_raw"]}
    return summary, counts


def write_cif_directory(root, n, seed):
    """``n`` MP-like synthetic structures as ``{id}.cif`` + id_prop.csv
    under ``root`` (emptied first), written by the port's
    ``write_cif_file`` -> the ids in order."""
    import shutil

    import numpy as np

    from cgnn_tpu_torch.data.cif import write_cif_file
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ids, rows = [], []
    for sid, s, t in synthetic_mp_dataset(n, seed=seed):
        write_cif_file(s, os.path.join(root, f"{sid}.cif"), name=sid)
        rows.append(f"{sid},{float(np.atleast_1d(t)[0])!r}")
        ids.append(sid)
    with open(os.path.join(root, "id_prop.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return ids


GRAPH_FIELDS = ("atom_fea", "edge_fea", "centers", "neighbors", "target",
                "target_mask", "distances", "positions", "lattice",
                "offsets")


def graphs_bit_equal(got, want) -> bool:
    import numpy as np

    if [g.cif_id for g in got] != [g.cif_id for g in want]:
        return False
    for a, b in zip(got, want):
        for f in GRAPH_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                return False
            if x is not None and not (
                    np.asarray(x).dtype == np.asarray(y).dtype
                    and np.array_equal(np.asarray(x), np.asarray(y))):
                return False
    return True


def loader_breakdown(dev, train_g, loader, steps=8):
    """The per-step training loop (kernel path, batch 256) fed through the
    prefetch loader (``loader``; batches packed page-locked, as ``fit``
    packs them on a card) or with each batch packed pageable and copied
    on this thread: loop ms a step, the loader's wait a step, then the
    device's busy time (profiler, copies included) and its idle share of
    the loop."""
    import functools

    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import (
        batch_iterator,
        count_batches,
        pack_graphs,
    )
    from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
    from cgnn_tpu_torch.train.step import make_train_step

    _, state, node_cap, edge_cap = new_state(dev, train_g,
                                             cgconv_impl="pallas")
    step = make_train_step()
    rng = np.random.default_rng(SEED + 7)

    def host_batches():
        while True:
            yield from batch_iterator(
                train_g, BATCH, node_cap, edge_cap, shuffle=True, rng=rng,
                dense_m=M, snug=True,
                pack_fn=functools.partial(pack_graphs, pin=True) if loader
                else None)

    stats = LoaderStats()
    staged = (prefetch_to_device(host_batches(), dev, size=2, stats=stats)
              if loader else (b.to(dev) for b in host_batches()))
    try:
        for _ in range(2):  # warm-up
            step(state, next(staged))
        torch.cuda.synchronize()
        wait0 = stats.loader_wait_s
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, next(staged))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        wait_s = stats.loader_wait_s - wait0
        busy_ms, by_kernel, _ = device_busy_ms(
            lambda: step(state, next(staged)), steps)
    finally:
        staged.close()
    per_batch = len(train_g) / count_batches(train_g, BATCH, node_cap,
                                             edge_cap, snug=True)
    res = {"loader": loader, "steps": steps,
           "loop_ms_per_step": loop_s * 1e3 / steps,
           "train_structures_per_s": per_batch * steps / loop_s,
           "loader_wait_ms_per_step": wait_s * 1e3 / steps if loader
           else None,
           "loader_put_ms_per_batch": (stats.loader_put_s * 1e3
                                       / max(stats.batches, 1)) if loader
           else None,
           "step_device_busy_ms": busy_ms}
    if busy_ms is not None:
        res["device_idle_share_of_loop"] = 1.0 - busy_ms / res[
            "loop_ms_per_step"]
        res["top_device_ops_ms_per_step"] = {
            k[:80]: v for k, v in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:6]}
    print(f"loader_breakdown: {res}")
    return res


def compact_flush_breakdown(dev, server, graphs, reps=10):
    """One top-rung compact flush of ``graphs`` on a compact server, split
    like ``flush_breakdown``: host pack into a pinned staging buffer, the
    asynchronous host-to-device copy (synchronized), the predict step
    (expander and model; host wall with a synchronize), the copy back;
    the bytes staged beside the full form's; the expander's device time
    alone and the step's device busy time and idle share (profiler)."""
    import torch

    ss, step, state = server.shape_set, server.predict_step, server.state
    top = ss.largest
    buf = ss.buffer_factory(top, pin=dev.type == "cuda")()
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = ss.pack(graphs, shape=top, out=buf)
        t1 = time.perf_counter()
        on_dev = batch.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    full = ss.pack_full(graphs, shape=top)
    res = {"graphs": len(graphs), "nodes": sum(g.num_nodes for g in graphs),
           "rung": list(vars(top).values()),
           "staged_bytes": sum(t.nbytes for t in batch.tensors()),
           "full_staged_bytes": sum(
               v.nbytes for v in vars(full).values()
               if isinstance(v, torch.Tensor))}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    expander = ss.expander(dev)
    res["expander_device_ms"] = device_ms(lambda: expander(on_dev))
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    res["step_device_busy_ms"] = busy_ms
    if busy_ms is not None:
        k1 = sum(v for k, v in by_kernel.items() if "fused_cgconv_eval_" in k)
        res.update({
            "fused_kernel_ms_per_step": k1,
            "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
            "top_kernels_ms_per_step": {
                k[:80]: v for k, v in sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1])[:6]}})
    return res


def cif_pipeline_phase(dev, work_dir, card, calibration):
    """Paths 'train_cif', 'predict_compact', 'predict_cif_full',
    'predict_cif_raw' and 'serve_compact': CIF directory -> preprocess ->
    cache -> train -> predict (compact, full, raw) -> compact serving
    (module docstring, item 8). -> (summary, counts by path, the loader
    and compact flush breakdowns)."""
    import csv as csvmod
    import dataclasses as dc
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.cache import load_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_cif_directory,
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.data.preprocess import main as preprocess_main
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import InferenceState

    data_cfg = DataConfig()
    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    n_conv = model_cfg.n_conv
    cif_dir = os.path.join(work_dir, "cif")
    cache = os.path.join(work_dir, "cif_graphs.npz")
    counts, summary = {}, {"card": card, "structures": N_CIF}

    # 1. the CIF directory
    t0 = time.perf_counter()
    ids = write_cif_directory(cif_dir, N_CIF, SEED + 11)
    summary["write_cifs_s"] = time.perf_counter() - t0

    # 2. the preprocess entry point, 8 worker processes
    if os.path.exists(cache):
        os.remove(cache)
    t0 = time.perf_counter()
    rc, _ = run_main(preprocess_main, [cif_dir, "-o", cache, "-j",
                                       str(PREPROCESS_WORKERS)],
                     "preprocess")
    pre_s = time.perf_counter() - t0
    check(rc == 0, f"preprocess exited {rc}")
    graphs = load_graph_cache(cache)
    t0 = time.perf_counter()
    direct = load_cif_directory(cif_dir, data_cfg.featurize_config())
    serial_s = time.perf_counter() - t0
    equal = graphs_bit_equal(graphs, direct)
    print(f"preprocess: {len(graphs)} structures, -j {PREPROCESS_WORKERS} "
          f"in {pre_s!r} s "
          f"({len(graphs) / pre_s!r} structures/s), in-process "
          f"load_cif_directory {serial_s!r} s; cache bit-equal to it: "
          f"{'ok' if equal else 'FAIL'}")
    check(equal and [g.cif_id for g in graphs] == ids,
          "the preprocessed cache differs from load_cif_directory")
    summary.update(preprocess_s=pre_s,
                   preprocess_structures_per_s=len(graphs) / pre_s,
                   load_cif_directory_s=serial_s,
                   atoms=sum(g.num_nodes for g in graphs))

    # 3. the train entry point from DIR --cache
    train_g, val_g, test_g = train_val_test_split(graphs, 0.8, 0.1,
                                                  seed=SEED)
    _, node_cap, edge_cap = init_train_state(model_cfg, data_cfg, train_g,
                                             batch_size=BATCH, device=dev,
                                             seed=SEED)
    steps, evals, tests = (count_batches(g, BATCH, node_cap, edge_cap,
                                         snug=True)
                           for g in (train_g, val_g, test_g))
    ck = os.path.join(work_dir, "cif_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = [cif_dir, "--cache", cache, "-b", str(BATCH), "--epochs",
            str(EPOCHS), "--cgconv-impl", "pallas", "--ckpt-dir", ck,
            "--out-dir", os.path.join(work_dir, "cif_out"), "--print-freq",
            "0", "--seed", str(SEED)]
    per_step = dense_per_step(n_conv)
    with PathRun("train_cif") as run:
        t0 = time.perf_counter()
        rc, out = run_main(train_main, argv, "train_cif")
        torch.cuda.synchronize()
        summary["train_wall_s"] = time.perf_counter() - t0
    check(rc == 0 and f"loaded {N_CIF} graphs from {cache}" in out,
          f"train entry point on the cache: rc {rc}")
    counts["train_cif"] = check_path(
        run, per_step, {"train": EPOCHS * steps,
                        "eval": EPOCHS * evals + tests})
    summary["train"] = {"split": [len(train_g), len(val_g), len(test_g)],
                        "steps_per_epoch": steps, "node_cap": node_cap}

    # 4. the per-step loop with the loader and without it, in turns
    loader = [loader_breakdown(dev, train_g, on)
              for on in (True, False, False, True)]

    # 5. the predict entry point: compact and full on the cache, raw wire
    # from the directory, against the plain model on the card
    plain = InferenceState(
        build_model(dc.replace(model_cfg, cgconv_impl=""), data_cfg,
                    device=dev),
        Normalizer.identity(1, device=dev))
    mgr = CheckpointManager(ck)
    plain = mgr.restore_for_inference(plain, "latest")
    mgr.close()
    want_preds, _ = run_fast_inference(
        plain, graphs, CIF_PREDICT_BATCH,
        shape_set=plan_shape_set(graphs, CIF_PREDICT_BATCH, rungs=2,
                                 dense_m=M))
    runs, preds, rates = {}, {}, {}
    flags_of = {
        "predict_compact": ["--cache", cache, "--wire", "featurized",
                            "--compact", "on"],
        "predict_cif_full": ["--cache", cache, "--wire", "featurized",
                             "--compact", "off"],
        "predict_cif_raw": ["--wire", "raw", "--compact", "on"]}
    # compact and full in turns (A, B, B, A); each path's first run is
    # its path run (traced), which its counts and checks come from; the
    # repeats run untraced, for their rates
    for path in ("predict_compact", "predict_cif_full", "predict_cif_full",
                 "predict_compact", "predict_cif_raw"):
        flags = flags_of[path]
        out_csv = os.path.join(work_dir, f"{path}.csv")
        head = [ck, cif_dir] if path == "predict_cif_raw" else [ck]
        argv_p = head + flags + ["--pack-workers", "2", "-b",
                                 str(CIF_PREDICT_BATCH), "--out", out_csv]
        if path in runs:  # the repeat: its rate only
            rc, out = run_main(predict_main, argv_p, path)
            check(rc == 0, f"{path}: predict exited {rc}")
            rates[path].append(json.loads(next(
                line for line in out.splitlines()
                if line.startswith("predict: "))[9:])["structures_per_s"])
            continue
        with PathRun(path) as run:
            rc, out = run_main(predict_main, argv_p, path)
        check(rc == 0, f"{path}: predict exited {rc}")
        info = json.loads(next(line for line in out.splitlines()
                               if line.startswith("predict: "))[9:])
        rows = list(csvmod.reader(open(out_csv)))
        got = np.array([[float(x) for x in r[2:]] for r in rows])
        err = np.abs(got - want_preds)
        ok = ([r[0] for r in rows] == ids and got.shape == want_preds.shape
              and bool(np.all(err <= SERVE_ATOL
                              + SERVE_RTOL * np.abs(want_preds))))
        batches = info["batches_raw"] + info["batches_featurized"]
        counts[path] = predict_path(run, per_step, info)
        print(f"{path}: {N_CIF} structures ({info['raw']} raw-staged, "
              f"compact {info['compact']}), {batches} batches, pipeline "
              f"{info['pipeline']}; max_abs_err vs the plain model "
              f"{float(err.max())!r}: {'ok' if ok else 'FAIL'}")
        check(ok, f"{path}: the CSV disagrees with the plain model")
        check(batches > 0, f"{path}: no batch")
        check(info["compact"] == (path != "predict_cif_full"),
              f"{path}: compact staging {info['compact']}")
        runs[path] = dict(info, max_abs_err_vs_plain=float(err.max()))
        preds[path] = got
        rates[path] = [info["structures_per_s"]]
    check(runs["predict_compact"]["pipeline"]["buffers_reused"]
          > 4 * runs["predict_compact"]["pipeline"]["buffers_allocated"] > 0,
          f"the pooled buffers did not recycle: "
          f"{runs['predict_compact']['pipeline']}")
    check(runs["predict_cif_raw"]["batches_raw"] > 0,
          "predict --wire raw staged nothing raw")
    compact_vs_full = float(np.abs(preds["predict_compact"]
                                   - preds["predict_cif_full"]).max())
    check(bool(np.allclose(preds["predict_compact"],
                           preds["predict_cif_full"], rtol=SERVE_RTOL,
                           atol=SERVE_ATOL)),
          f"compact and full CSVs differ by {compact_vs_full!r}")

    # 6. compact serving: a flush broken down, then the 224-graph burst
    npz = os.path.join(work_dir, "params.npz")
    meta = os.path.join(work_dir, "meta.json")
    kw = dict(batch_size=64, rungs=3, calibration=calibration, device=dev,
              default_timeout_ms=60_000.0, wire="featurized", cache_size=0,
              log_fn=lambda *a: None)
    server, _ = load_server(npz, meta, compact="on", **kw)
    check(server.shape_set.compact is not None,
          "load_server(compact='on') planned no compact spec")
    breakdown = compact_flush_breakdown(dev, server, calibration)
    burst_graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                                     seed=SEED + 1)

    def fresh():
        # new graph objects: no admission verdict cached from a burst
        return [dc.replace(g) for g in burst_graphs]

    # the compactability probe's host time a graph: one graph a call (the
    # JAX package's admission probe), then the worker's batched pass
    probe_us = {}
    for how, probe in (("one_at_a_time", fresh()), ("batched", fresh())):
        t0 = time.perf_counter()
        if how == "batched":
            ok = all(server.shape_set.compact.compactable_many(probe))
        else:
            ok = all(server.shape_set.compactable(g) for g in probe)
        probe_us[how] = (time.perf_counter() - t0) / len(probe) * 1e6
        check(ok, "a burst graph cannot stage compactly")
    full_server, _ = load_server(npz, meta, compact="off", **kw)
    # the path run (traced: every flush packed compact), then compact,
    # full, full, compact untraced: the A/B in turns, requests/s each
    c0 = dict(server.counts)
    comp = burst(server, fresh(), "serve_compact", per_step)
    counts["serve_compact"] = comp.pop("path")
    packed = {k: server.counts[k] - c0[k] for k in ("pack_compact",
                                                    "pack_full")}
    turns = [(form, burst(srv, fresh())) for form, srv in (
        ("compact", server), ("full", full_server), ("full", full_server),
        ("compact", server))]
    full = turns[1][1]
    check(server.drain(timeout_s=60), "the compact server did not drain")
    check(full_server.drain(timeout_s=60), "the full server did not drain")
    err = float(np.abs(comp["preds"] - full["preds"]).max())
    ok = (packed == {"pack_compact": comp["flushes"], "pack_full": 0}
          and comp["flushes"] > 0 and bool(np.allclose(comp["preds"], full["preds"],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)))
    print(f"serve_compact: {N_GRAPHS} graphs, {comp['flushes']} flushes "
          f"{packed}; max_abs_err vs the full "
          f"server {err!r}: {'ok' if ok else 'FAIL'}")
    check(ok, "the compact server's flushes or answers are off")
    for r in [comp] + [r for _, r in turns]:
        r.pop("preds")
        r.pop("wires")
    summary.update(
        predict_structures_per_s=rates,
        predict=runs, predict_compact_vs_full_max_abs_diff=compact_vs_full,
        serve_compact=dict(comp, packed=packed,
                           max_abs_err_vs_full_server=err,
                           probe_us_per_graph=probe_us),
        serve_turns=[(form, {k: r[k] for k in (
            "flushes", "requests_per_s", "latency_ms_p50",
            "latency_ms_p99")}) for form, r in turns])
    return summary, counts, {"loader_breakdown": loader,
                             "compact_flush_breakdown": breakdown}


N_SEARCH_MP = 64  # MP-like cells of the data_layer phase's search check
N_SEARCH_SLABS = 8  # OC20-like slabs of it
DL_EPOCHS = 5  # the data_layer phase's training runs (rates: epochs 2-5)
COO_CAPS = (3000, 36000)  # --node-cap/--edge-cap of its COO path
MEMORY_SLACK = 8 * 2**20  # a dropped fit's allocation left, at most (B)
# the conventional cubic cells whose M-th neighbor sits on a distance
# tie (tests/test_torch_ties.py): lattice constant (A), fractional
# positions, atomic numbers
_FCC = [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
TIE_CELLS = {
    "SrTiO3": (3.905, [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.5, 0.0],
                       [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]], [38, 22, 8, 8, 8]),
    "Cu": (3.615, _FCC, [29] * 4),
    "NaCl": (5.640, _FCC + [[(x + 0.5) % 1.0, y, z] for x, y, z in _FCC],
             [11] * 4 + [17] * 4),
    "Si": (5.431, _FCC + [[x + 0.25, y + 0.25, z + 0.25]
                          for x, y, z in _FCC], [14] * 8),
}


def search_check(card) -> dict:
    """The native host neighbor search against the numpy one at the
    flagship's radius on MP-like cells, OC20-like slabs and the tie cells:
    every array bit-equal, order included (the k-nearest cut at M too);
    each structure's search timed once both ways after a warm call."""
    import numpy as np

    from cgnn_tpu_torch import native
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.neighbors import knn_neighbor_list, neighbor_list
    from cgnn_tpu_torch.data.structure import Structure
    from cgnn_tpu_torch.data.synthetic import (
        synthetic_mp_dataset,
        synthetic_oc20_dataset,
    )

    radius = DataConfig().radius
    sets = {
        "mp": [s for _, s, _ in synthetic_mp_dataset(N_SEARCH_MP,
                                                     seed=SEED + 21)],
        "slabs": [s for _, s, _ in synthetic_oc20_dataset(N_SEARCH_SLABS,
                                                          seed=SEED + 22)],
        "ties": [Structure(np.eye(3) * a, frac, z)
                 for a, frac, z in TIE_CELLS.values()]}
    fields = ("centers", "neighbors", "distances", "offsets")
    neighbor_list(sets["ties"][0], radius, backend="native")  # build, warm
    out = {"card": card, "radius": radius}
    for name, structures in sets.items():
        t_np = t_nat = 0.0
        edges = 0
        for s in structures:
            t0 = time.perf_counter()
            want = neighbor_list(s, radius, backend="numpy")
            t1 = time.perf_counter()
            got = neighbor_list(s, radius, backend="native")
            t2 = time.perf_counter()
            check(native.backend_used() == "native",
                  f"search {name}: backend {native.backend_used()}")
            t_np += t1 - t0
            t_nat += t2 - t1
            edges += len(got)
            knn = [knn_neighbor_list(s, radius, M, backend=b,
                                     warn_under_coordinated=False)
                   for b in ("native", "numpy")]
            for a, b in ((got, want), tuple(knn)):
                check(all(getattr(a, f).dtype == getattr(b, f).dtype
                          and np.array_equal(getattr(a, f), getattr(b, f))
                          for f in fields),
                      f"search {name}: native and numpy differ")
        n = len(structures)
        out[name] = {
            "structures": n,
            "atoms": [min(s.num_atoms for s in structures),
                      max(s.num_atoms for s in structures)],
            "pairs": edges, "numpy_ms_per_structure": t_np / n * 1e3,
            "native_ms_per_structure": t_nat / n * 1e3,
            "speedup": t_np / t_nat}
        print(f"search {name}: {n} structures bit-equal native vs numpy "
              f"(pairs and the k-nearest cut at M={M}); ms a structure "
              f"numpy {t_np / n * 1e3!r}, native {t_nat / n * 1e3!r} "
              f"({t_np / t_nat!r}x)")
    return out


def preprocess_backends(cif_dir, work_dir) -> tuple[dict, str]:
    """``python -m cgnn_tpu_torch.data.preprocess DIR -j 8`` with the
    native search (g++ on PATH) and with the numpy one (PATH emptied:
    'auto' resolves to numpy in the entry point and in each worker): the
    two caches bit-equal -> (rates, the native cache's path)."""
    from cgnn_tpu_torch.data.cache import load_graph_cache
    from cgnn_tpu_torch.data.preprocess import main as preprocess_main

    out, caches = {}, {}
    for backend in ("native", "numpy"):
        cache = os.path.join(work_dir, f"data_layer_{backend}.npz")
        path_was = os.environ.get("PATH", "")
        if backend == "numpy":
            os.environ["PATH"] = ""
        try:
            t0 = time.perf_counter()
            rc, said = run_main(preprocess_main, [
                cif_dir, "-o", cache, "-j", str(PREPROCESS_WORKERS)],
                f"preprocess_{backend}")
            wall = time.perf_counter() - t0
        finally:
            os.environ["PATH"] = path_was
        check(rc == 0 and f"(neighbor search: {backend})" in said,
              f"preprocess with the {backend} search: rc {rc}")
        caches[backend] = load_graph_cache(cache)
        out[f"{backend}_structures_per_s"] = len(caches[backend]) / wall
        out[f"{backend}_s"] = wall
    equal = graphs_bit_equal(caches["native"], caches["numpy"])
    print(f"preprocess -j {PREPROCESS_WORKERS}: native "
          f"{out['native_structures_per_s']!r} structures/s, numpy "
          f"{out['numpy_structures_per_s']!r}; caches bit-equal: "
          f"{'ok' if equal else 'FAIL'}")
    check(equal, "the native and numpy preprocess caches differ")
    out["speedup"] = out["numpy_s"] / out["native_s"]
    return out, os.path.join(work_dir, "data_layer_native.npz")


def dropped_fit_memory(dev, split) -> dict:
    """Two full-width ``fit`` runs under the epoch driver (ladder packing,
    the kernel path), each dropped with the collector off: the card's
    allocation before each, its peak, after, and after a ``gc.collect()``
    (MiB). The second (after the first made what cuBLAS keeps for the
    process: a workspace for each stream it runs on) must end within
    MEMORY_SLACK of where it began, without the collect."""
    import gc

    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.state import init_train_state

    train_g, val_g, _ = split
    state, _, _ = init_train_state(
        ModelConfig(dense_m=M, cgconv_impl="pallas"), DataConfig(), train_g,
        batch_size=BATCH, device=dev, seed=SEED, packing="ladder")
    runs = []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        gc.disable()
        try:
            state, result = fit(state, train_g, val_g, epochs=2,
                                batch_size=BATCH, dense_m=M, device=dev,
                                seed=SEED, scan_epochs=True,
                                packing="ladder", log_fn=lambda *_: None)
            check(result["graphs"]["captures"] > 0,
                  "the fit captured nothing")
            del result
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(dev)
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            gc.enable()
        gc.collect()
        torch.cuda.synchronize()
        runs.append({"before_mib": before / 2**20, "peak_mib": peak / 2**20,
                     "after_mib": after / 2**20,
                     "after_collect_mib":
                     torch.cuda.memory_allocated(dev) / 2**20})
    last = runs[-1]
    ok = ((last["after_mib"] - last["before_mib"]) * 2**20 < MEMORY_SLACK
          and last["peak_mib"] > last["before_mib"]
          and all(r["after_collect_mib"] == r["after_mib"] for r in runs))
    print(f"dropped fits, card memory: "
          f"{json.dumps(runs, allow_nan=False)}: {'ok' if ok else 'FAIL'}")
    check(ok, f"a dropped fit kept card memory: {runs}")
    return {"runs": runs}


def corrupted_cache_exit(cache, work_dir) -> dict:
    """The train entry point with ``--check-invariants`` on a copy of the
    cache whose first graph's neighbors are out of range (the spot check
    samples it): a non-zero exit naming the check."""
    import numpy as np

    bad = os.path.join(work_dir, "data_layer_corrupted.npz")
    with np.load(cache) as z:
        payload = {k: np.asarray(z[k]).copy() for k in z.files}
    payload["neighbors"][: int(payload["edge_counts"][0])] = 10**6
    with open(bad, "wb") as f:
        np.savez(f, **payload)
    proc = subprocess.run(
        [sys.executable, "-m", "cgnn_tpu_torch.train", "--cache", bad,
         "--check-invariants", "-b", str(BATCH), "--epochs", "1",
         "--ckpt-dir", os.path.join(work_dir, "data_layer_bad_ck"),
         "--out-dir", os.path.join(work_dir, "data_layer_bad_out")],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    named = ("BatchInvariantError" in proc.stderr
             and "edge endpoints out of range" in proc.stderr)
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    print(f"corrupted cache under --check-invariants: exit "
          f"{proc.returncode}, {last!r}: "
          f"{'ok' if proc.returncode != 0 and named else 'FAIL'}")
    check(proc.returncode != 0 and named,
          f"the corrupted cache was not refused by name: {proc.stderr!r}")
    return {"exit": proc.returncode, "error": last}


def data_layer_phase(dev, work_dir, card):
    """Paths 'data_ladder_train', 'data_coo_caps' and
    'data_predict_ladder': the rest of the data layer on the card (module
    docstring, item 15) -> (summary, counts by path)."""
    import csv as csvmod
    import shutil

    import numpy as np

    from cgnn_tpu_torch.config import ModelConfig
    from cgnn_tpu_torch.data.cache import load_graph_cache
    from cgnn_tpu_torch.data.dataset import train_val_test_split
    from cgnn_tpu_torch.data.graph import capacities_for, count_batches
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.train.__main__ import main as train_main

    t_phase = time.perf_counter()
    n_conv = ModelConfig().n_conv
    root = os.path.join(work_dir, "data_layer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    counts, summary = {}, {"card": card}

    # (a) the native search against the numpy one
    summary["search"] = search_check(card)

    # (b) preprocess -j 8 of the cif_pipeline directory, both searches
    cif_dir = os.path.join(work_dir, "cif")
    if not os.path.exists(os.path.join(cif_dir, "id_prop.csv")):
        write_cif_directory(cif_dir, N_CIF, SEED + 11)
    summary["preprocess"], cache = preprocess_backends(cif_dir, root)
    graphs = load_graph_cache(cache)
    split = train_val_test_split(graphs, 0.8, 0.1, seed=SEED)

    # (c) the train entry point, dense, ladder packing, the checks, the
    # epoch driver: the traced run, then the rates with the checks on and
    # off in turns, and snug packing for its padding
    def train_argv(name, *extra):
        return [cif_dir, "--cache", cache, "-b", str(BATCH), "--epochs",
                str(DL_EPOCHS), "--scan-epochs", "--print-freq", "0",
                "--seed", str(SEED), "--ckpt-dir",
                os.path.join(root, f"{name}_ck"), "--out-dir",
                os.path.join(root, f"{name}_out"), *extra]

    # the dense runs take the kernel path (kernels 1, 2, 4 and 5)
    ladder = ["--cgconv-impl", "pallas", "--packing", "ladder"]
    out, info, counts["data_ladder_train"] = entry_train(
        "data_ladder_train", train_argv("ladder", *ladder,
                                        "--check-invariants"),
        dense_per_step(n_conv),
        entry_logical(split, M, DL_EPOCHS, snug=False))
    check(info["padding"]["summary"] in out,
          "data_ladder_train: no padding line")

    def rate_run(name, *extra):
        rc, out = run_main(train_main, train_argv(name, *extra), name)
        check(rc == 0, f"{name}: the train entry point exited {rc}")
        rec = json.loads(next(line for line in out.splitlines()
                              if line.startswith("train: "))[7:])
        eps = rec["epoch_seconds"]
        st = rec["staging"]
        return {"steady_structures_per_s":
                len(split[0]) * (len(eps) - 1) / sum(eps[1:]),
                "first_epoch_s": eps[0], "check_s": st["timings"]["check_s"],
                "pack_s": st["pack_s"], "stage_s": st["stage_s"],
                "capture_s": st["capture_s"], "padding": rec["padding"]}

    turns = [rate_run(f"ladder_{tag}{i}", *ladder, *flags)
             for i, (tag, flags) in enumerate((
                 ("checks", ["--check-invariants"]), ("plain", []),
                 ("plain", []), ("checks", ["--check-invariants"])))]
    snug = rate_run("snug_plain", "--cgconv-impl", "pallas")
    summary["train"] = {
        "ladder_checks_traced": {"padding": info["padding"],
                                 "staging": info["staging"]},
        "turns_checks_plain_plain_checks": turns, "snug": snug}
    for tag, rec in (("ladder", turns[1]), ("snug", snug)):
        print(f"data_layer {tag}: {rec['padding']['summary']}; steady "
              f"{rec['steady_structures_per_s']!r} structures/s")
    print("data_layer checks on/off, steady structures/s: "
          f"{[t['steady_structures_per_s'] for t in turns]!r}; check_s "
          f"{[t['check_s'] for t in turns]!r}")
    check(snug["padding"]["node_efficiency"]
          > turns[1]["padding"]["node_efficiency"],
          "snug packing padded more than the ladder")

    # (d) COO with kernel 6 at the user's capacities
    out, info, counts["data_coo_caps"] = entry_train(
        "data_coo_caps", train_argv(
            "coo_caps", "--aggregation", "pallas", "--node-cap",
            str(COO_CAPS[0]), "--edge-cap", str(COO_CAPS[1])),
        coo_per_step(n_conv),
        entry_logical(split, None, DL_EPOCHS, caps=COO_CAPS))
    check(info["padding"]["shapes"] == [list(COO_CAPS)],
          f"data_coo_caps: batch shapes {info['padding']['shapes']}")
    summary["coo_caps"] = {"shapes": info["padding"]["shapes"],
                           "padding": info["padding"]["summary"]}
    print(f"data_coo_caps: every batch {info['padding']['shapes']}: ok")

    # (e) predict with --packing ladder on (c)'s checkpoint, against snug
    ck = os.path.join(root, "ladder_ck")
    preds = {}
    for packing in ("ladder", "snug"):
        out_csv = os.path.join(root, f"predict_{packing}.csv")
        argv = [ck, "--cache", cache, "--packing", packing, "--buckets",
                "1", "--wire", "featurized", "--compact", "off", "-b",
                str(BATCH), "--out", out_csv]
        if packing == "ladder":
            with PathRun("data_predict_ladder") as run:
                rc, out = run_main(predict_main, argv, "data_predict_ladder")
            check(rc == 0, f"data_predict_ladder exited {rc}")
            pinfo = json.loads(next(line for line in out.splitlines()
                                    if line.startswith("predict: "))[9:])
            nc, ec = capacities_for(graphs, BATCH, dense_m=M, snug=False)
            check(pinfo["batches_featurized"] == count_batches(
                graphs, BATCH, nc, ec, snug=False),
                f"data_predict_ladder: {pinfo['batches_featurized']} "
                f"batches")
            counts["data_predict_ladder"] = predict_path(
                run, dense_per_step(n_conv), pinfo)
        else:
            rc, _ = run_main(predict_main, argv, "predict_snug")
            check(rc == 0, f"predict --packing snug exited {rc}")
        rows = list(csvmod.reader(open(out_csv)))
        check([r[0] for r in rows] == [g.cif_id for g in graphs],
              f"predict --packing {packing}: ids")
        preds[packing] = np.array([[float(x) for x in r[2:]] for r in rows])
    err = np.abs(preds["ladder"] - preds["snug"])
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL
                     * np.abs(preds["snug"])))
    print(f"predict --packing ladder vs snug: max_abs_err "
          f"{float(err.max())!r}: {'ok' if ok else 'FAIL'}")
    check(ok, "ladder predictions disagree with snug ones")
    summary["predict"] = {"batches": pinfo["batches_featurized"],
                          "structures_per_s": pinfo["structures_per_s"],
                          "max_abs_err_vs_snug": float(err.max())}

    # (f) a corrupted cache under --check-invariants; the memory of a
    # dropped fit
    summary["corrupted_cache"] = corrupted_cache_exit(cache, root)
    summary["dropped_fit_memory"] = dropped_fit_memory(dev, split)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"data_layer: {summary['seconds']!r} s")
    return summary, counts


N_DRIVER = 2048  # the step_graphs phase: --synthetic N, and MP-like N
DRIVER_EPOCHS = 3
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-6  # graphs vs eager, where not bit-equal
REPLAY_TOL = 1e-6  # a replayed answer vs the eager one, where not bit-equal
# compact staging against full under the driver: the JAX package's
# tolerance for the two trajectories (tests/test_compact.py, val MAE rel
# 2e-2 over 3 epochs), and the expander's bound on an expanded edge
# feature (tests/test_compact.py, tests/test_torch_compact.py)
COMPACT_RTOL, EDGE_ATOL = 2e-2, 2e-6
# what differs where two runs that should be bit-equal are not: the graph
# pooling sums in a fixed order (ops/segment.py ``segment_mean``), so the
# rest is an op PyTorch orders freely without deterministic algorithms
NONDET_OP = ("an op PyTorch runs in no fixed order without deterministic "
             "algorithms (the graph pooling's sums are fixed-order: "
             "cgnn_tpu_torch/ops/segment.py segment_mean)")


class ProfileWindow:
    """A torch.profiler trace opened and closed by hand: ``start()`` after
    a synchronize, ``stop()`` -> (wall ms, device busy ms, idle share) of
    the window, busy being the sum of its kernels' device time."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.stop()
        busy = sum(e.self_device_time_total for e in self.prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        return wall, busy, (1.0 - busy / wall) if busy > 0 else None


def steady_rate(history, n_train) -> float:
    """Train structures a second over the epochs after the first (their
    train and validation wall)."""
    later = history[1:]
    return n_train * len(later) / sum(h["seconds"] for h in later)


def driver_entry_runs(dev, work_dir, counts):
    """The train entry point as a user runs it on the card: --synthetic
    2048 --device-resident --buckets 3 -b 256 --epochs 3, with
    --cgconv-impl pallas (compact staging auto -> on; path
    driver_compact), again with --compact-staging off (driver_full), and
    with --aggregation pallas (the COO layout, full staging; driver_coo).
    Launches exact against the batches: each epoch runs every staged
    train and validation batch once, then the test split is evaluated
    eagerly; no capture after warm-up."""
    import shutil

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import (
        bucketed_batch_iterator,
        count_batches,
    )
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.state import init_train_state

    data_cfg = DataConfig()
    graphs = load_synthetic(N_DRIVER, data_cfg.featurize_config(), seed=SEED)
    train_g, val_g, test_g = train_val_test_split(graphs, 0.8, 0.1,
                                                  seed=SEED)
    logical = {}
    for layout, cfg in (("dense", ModelConfig(dense_m=M)),
                        ("coo", ModelConfig(dense_m=0, aggregation=COO_AGG))):
        _, nc, ec = init_train_state(cfg, data_cfg, train_g, batch_size=BATCH,
                                     device=dev, seed=SEED)
        dm = cfg.dense_m or None
        steps, evals = (sum(1 for _ in bucketed_batch_iterator(
            g, BATCH, 3, dense_m=dm)) for g in (train_g, val_g))
        logical[layout] = {"train": DRIVER_EPOCHS * steps,
                           "eval": DRIVER_EPOCHS * evals + count_batches(
                               test_g, BATCH, nc, ec, snug=True)}
    base = ["--synthetic", str(N_DRIVER), "--device-resident", "--buckets",
            "3", "-b", str(BATCH), "--epochs", str(DRIVER_EPOCHS),
            "--print-freq", "0", "--seed", str(SEED)]
    runs_out = {}
    n_conv = ModelConfig().n_conv
    for path, extra in (
            ("driver_compact", ["--cgconv-impl", "pallas"]),
            ("driver_full", ["--cgconv-impl", "pallas", "--compact-staging",
                             "off"]),
            ("driver_coo", ["--aggregation", COO_AGG])):
        ck = os.path.join(work_dir, f"{path}_ckpt")
        shutil.rmtree(ck, ignore_errors=True)
        argv = base + extra + ["--ckpt-dir", ck, "--out-dir",
                               os.path.join(work_dir, f"{path}_out")]
        with PathRun(path) as run:
            rc, out = run_main(train_main, argv, path)
        check(rc == 0, f"{path}: the train entry point exited {rc}")
        info = json.loads(next(line for line in out.splitlines()
                               if line.startswith("train: "))[7:])
        g, st = info["graphs"], info["staging"]
        compact = path == "driver_compact"
        check(g["captures"] > 0 and g["captures_after_warm"] == 0
              and st["compact"] == compact
              and ("compact staging: on" in out) == compact
              and "fallback" not in st,
              f"{path}: graphs {g}, staging {st}")
        coo = path == "driver_coo"
        counts[path] = check_path(
            run, coo_per_step(n_conv) if coo else dense_per_step(n_conv),
            logical["coo" if coo else "dense"])
        tm = st["timings"]
        runs_out[path] = {
            "train_structures_per_s_by_epoch": info["train_structures_per_s"],
            "epoch_seconds": info["epoch_seconds"],
            "steady_train_structures_per_s": len(train_g) * (
                DRIVER_EPOCHS - 1) / sum(info["epoch_seconds"][1:]),
            "captures": g["captures"], "replays": g["replays"],
            "captures_after_warm": g["captures_after_warm"],
            "staged_bytes": st["staged_bytes"], "compact": st["compact"],
            "host_ms_per_train_step": tm["train_dispatch_s"] * 1e3
            / tm["train_steps"],
            "host_ms_per_eval_step": tm["eval_dispatch_s"] * 1e3
            / max(tm["eval_steps"], 1),
            "capture_s": st["capture_s"], "stage_s": st["stage_s"],
            "pack_s": st["pack_s"], "traced": True}
        print(f"{path}: {json.dumps(runs_out[path], allow_nan=False)}")
    return runs_out


def driver_rate_pairs(dev, split, spec):
    """The epoch driver (graphs, compact staging, 3 buckets) against the
    eager per-step loop (host packing each epoch through the prefetch
    loader, one bucket) on the same MP-like split at batch 256, in turns
    driver, loop, loop, driver; the first of each traced by the profiler
    over epochs 2-3 (device busy, idle share)."""
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    out = {"driver": [], "eager_loop": []}
    for kind, traced in (("driver", True), ("eager_loop", True),
                         ("eager_loop", False), ("driver", False)):
        _, state, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
        window = ProfileWindow()
        traced_out = {}

        def hook(s, epoch, val_m, is_best):
            if traced and epoch == 0:
                window.start()

        kw = (dict(scan_epochs=True, buckets=3, compact=spec)
              if kind == "driver" else dict(graphs=False, prefetch=2))
        state, res = fit(state, train_g, val_g, epochs=DRIVER_EPOCHS,
                         batch_size=BATCH, dense_m=M, device=dev,
                         node_cap=node_cap, seed=SEED, log_fn=lambda s: None,
                         on_epoch_end=hook, **kw)
        if traced:
            wall, busy, idle = window.stop()
            traced_out = {"traced_wall_ms": wall, "device_busy_ms": busy,
                          "device_idle_share": idle}
        hist = res["history"]
        steps = sum(h["train"]["steps"] for h in hist[1:])
        run = {"traced": traced,
               "steady_train_structures_per_s": steady_rate(hist,
                                                            len(train_g)),
               "epoch_seconds": [h["seconds"] for h in hist],
               "train_steps_epochs_2_3": steps, **traced_out}
        if traced_out.get("device_busy_ms"):
            run["device_busy_ms_per_train_step"] = (
                traced_out["device_busy_ms"] / steps)
        if kind == "driver":
            tm = res["staging"]["timings"]
            run.update(graphs=res["graphs"],
                       host_ms_per_train_step=tm["train_dispatch_s"] * 1e3
                       / tm["train_steps"],
                       staged_bytes=res["staging"]["staged_bytes"])
            check(res["graphs"]["captures_after_warm"] == 0,
                  f"driver rate run captured after warm-up: {res['graphs']}")
        out[kind].append(run)
        print(f"rate pair {kind}: {json.dumps(run, allow_nan=False)}")
    return out


def driver_trajectory(dev, split, epochs=2):
    """One bucket, 2 epochs from the same weights: the epoch driver
    (replayed graphs) against the pack-once per-step loop stepped eagerly.
    Per-epoch train loss and val MAE within rel TRAJ_RTOL; every
    parameter, running statistic and optimizer buffer bit-equal under
    PyTorch's deterministic algorithms (else within TRAJ_RTOL/TRAJ_ATOL,
    the op named); and the same pair without them: its metrics within
    rel TRAJ_RTOL, its state's drift reported with the op named."""
    import torch

    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split

    def run(**kw):
        _, state, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
        state, res = fit(state, train_g, val_g, epochs=epochs,
                         batch_size=BATCH, dense_m=M, device=dev,
                         node_cap=node_cap, seed=SEED, log_fn=lambda s: None,
                         **kw)
        return state_bits(state), res["history"]

    out = {}
    for det in (True, False):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            (gb, gh), (eb, eh) = (run(scan_epochs=True),
                                  run(pack_once=True, graphs=False))
        finally:
            torch.use_deterministic_algorithms(False)
        equal, worst, where = bits_diff(gb, eb)
        metrics = [(g[p][k], e[p][k]) for g, e in zip(gh, eh)
                   for p, k in (("train", "loss"), ("val", "mae"))]
        close = all(abs(a - b) <= TRAJ_RTOL * abs(b) for a, b in metrics)
        within = all(torch.allclose(gb[k].double(), eb[k].double(),
                                    rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
                     for k in gb if k.startswith("model/"))
        out["deterministic" if det else "default"] = {
            "bit_equal": equal, "max_diff": worst, "worst": where,
            "metrics_graph_vs_eager": metrics, "metrics_within_rel": close,
            "params_and_stats_within_tol": within,
            "steps": [h["train"]["steps"] for h in gh]}
        check(close, f"driver trajectory (deterministic={det}): per-epoch "
                     f"metrics {metrics} beyond rel {TRAJ_RTOL}")
        if det:
            check(equal or within,
                  f"driver trajectory under deterministic algorithms: "
                  f"{out['deterministic']}")
            if not equal:
                out["deterministic"]["op"] = NONDET_OP
        elif not equal:  # reported, not held: the op named
            out["default"]["op"] = NONDET_OP
    print(f"driver trajectory: {json.dumps(out, allow_nan=False)}")
    return out


def driver_compact_trajectory(dev, split, spec, epochs=2):
    """The default device-resident training (3 buckets, compact staging,
    the expander inside the captured train and eval graphs) held on the
    card, 2 epochs from the same weights: replayed against the same
    schedule stepped eagerly (``graphs=False``) under deterministic
    algorithms, bit-equal in every tensor (else within TRAJ_RTOL /
    TRAJ_ATOL with the op named) and per-epoch metrics within rel
    TRAJ_RTOL; against full staging (3 buckets, replayed), per-epoch
    metrics within COMPACT_RTOL; and every staged training batch's
    expansion on the card against its full pack: edge features within
    the expander's EDGE_ATOL, every other field bit-equal."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.compact import compact_pack_fn, make_expander
    from cgnn_tpu_torch.data.graph import bucketed_batch_iterator
    from cgnn_tpu_torch.train.graphs import batch_tensors
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split

    def run(**kw):
        _, state, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
        state, res = fit(state, train_g, val_g, epochs=epochs,
                         batch_size=BATCH, dense_m=M, device=dev,
                         node_cap=node_cap, seed=SEED, log_fn=lambda s: None,
                         scan_epochs=True, buckets=3, **kw)
        return state_bits(state), res

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (gb, gres), (eb, eres) = (run(compact=spec),
                                  run(compact=spec, graphs=False))
    finally:
        torch.use_deterministic_algorithms(False)
    fb, fres = run()
    check(gres["staging"]["compact"] and not fres["staging"]["compact"]
          and gres["graphs"]["captures"] > 0
          and gres["graphs"]["captures_after_warm"] == 0
          and eres["graphs"]["captures"] == 0,
          f"compact driver runs: staging {gres['staging']}, graphs "
          f"{gres['graphs']} and eager {eres['graphs']}")

    def metrics(res):
        return [h[p][k] for h in res["history"]
                for p, k in (("train", "loss"), ("val", "mae"))]

    g_m, e_m, f_m = metrics(gres), metrics(eres), metrics(fres)
    equal, worst, where = bits_diff(gb, eb)
    within = all(torch.allclose(gb[k].double(), eb[k].double(),
                                rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
                 for k in gb if k.startswith("model/"))
    replay = {"bit_equal": equal, "max_diff": worst, "worst": where,
              "metrics_replayed_vs_eager": list(zip(g_m, e_m))}
    if not equal:
        replay["op"] = NONDET_OP
    check((equal or within)
          and all(abs(a - b) <= TRAJ_RTOL * abs(b) for a, b in
                  zip(g_m, e_m)),
          f"compact driver replayed vs eager: {replay}")
    rel = [abs(a - b) / abs(b) for a, b in zip(g_m, f_m)]
    check(max(rel) <= COMPACT_RTOL,
          f"compact vs full driver: metrics {g_m} vs {f_m} (rel {rel}, "
          f"want <= {COMPACT_RTOL})")
    # the expander at the cell's shapes: each training batch of the 3
    # buckets packed compactly and fully from the same draws
    expand = make_expander(spec, dev)
    edge_err, n_batches = 0.0, 0
    for cb, fb_ in zip(
            bucketed_batch_iterator(train_g, BATCH, 3, shuffle=True,
                                    rng=np.random.default_rng(SEED),
                                    dense_m=M,
                                    pack_fn=compact_pack_fn(spec)),
            bucketed_batch_iterator(train_g, BATCH, 3, shuffle=True,
                                    rng=np.random.default_rng(SEED),
                                    dense_m=M)):
        got = batch_tensors(expand(cb.to(dev)))
        want = batch_tensors(fb_.to(dev))
        edge_err = max(edge_err, float((got["edges"] - want["edges"])
                                       .abs().max()))
        same = [k for k in got if k != "edges"
                and torch.equal(got[k], want[k].to(got[k].dtype))]
        check(len(same) == len(got) - 1 and edge_err <= EDGE_ATOL,
              f"expanded batch {n_batches}: fields equal {same} of "
              f"{sorted(got)}, edge err {edge_err!r}")
        n_batches += 1
    out = {"replayed_vs_eager_deterministic": replay,
           "compact_vs_full_metrics": list(zip(g_m, f_m)),
           "compact_vs_full_max_rel": max(rel),
           "expanded_batches": n_batches,
           "expanded_edge_max_abs_err": edge_err,
           "captures": gres["graphs"]["captures"],
           "staged_bytes": {"compact": gres["staging"]["staged_bytes"],
                            "full": fres["staging"]["staged_bytes"]}}
    print(f"compact driver trajectory: {json.dumps(out, allow_nan=False)}")
    return out


def answers_equal(label, got, want):
    """A replayed answer against the eager one: bit-equal, or within
    REPLAY_TOL with the op named -> its record."""
    import torch

    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    diff = float((got.double() - want.double()).abs().max())
    ok = equal or bool(torch.allclose(got, want, rtol=REPLAY_TOL,
                                      atol=REPLAY_TOL))
    rec = {"bit_equal": equal, "max_abs_diff": diff}
    if not equal:
        rec["op"] = NONDET_OP
    check(ok, f"{label}: replayed answers differ from eager ones: {rec}")
    return rec


def serve_replays(dev, work_dir, calibration, coo_weights):
    """Every rung's predict graph of every staging form (full, compact,
    raw on the dense kernel weights; full on the COO weights) replayed
    on the calibration graphs that fit the rung, against the same step
    run eagerly, under PyTorch's deterministic algorithms (servers
    booted, so graphs captured, under them too): bit-equal, else within
    REPLAY_TOL with the op named; nothing captured after warm-up."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _serve_replays(dev, work_dir, calibration, coo_weights)
    finally:
        torch.use_deterministic_algorithms(False)


def _serve_replays(dev, work_dir, calibration, coo_weights):
    from cgnn_tpu_torch.data.rawbatch import raw_from_graph
    from cgnn_tpu_torch.serve.server import load_server

    npz, meta = (os.path.join(work_dir, f) for f in ("params.npz",
                                                     "meta.json"))
    out = {}
    for name, (w_npz, w_meta), kw in (
            ("dense", (npz, meta), dict(wire="raw", compact="on")),
            ("coo", coo_weights[:2], dict(wire="featurized"))):
        server, _ = load_server(w_npz, w_meta, batch_size=64, rungs=3,
                                calibration=calibration, device=dev,
                                cache_size=0, log_fn=lambda *a: None, **kw)
        ss, step, st = server.shape_set, server.predict_step, server.state
        try:
            for shape in ss:
                sub, n, e = [], 0, 0
                for g in calibration:  # the graphs that fit, in order
                    gn, ge = ss.graph_counts(g)
                    if shape.fits(len(sub) + 1, n + gn, e + ge):
                        sub.append(g)
                        n, e = n + gn, e + ge
                forms = {"full": ss.pack_full(sub, shape=shape)}
                if ss.compact is not None and all(
                        ss.compact.compactable_many(sub)):
                    forms["compact"] = ss.pack(sub, shape=shape)
                if ss.raw is not None:
                    raws = [r for r in map(raw_from_graph, calibration)
                            if ss.admits_raw(r)][:shape.graph_cap]
                    forms["raw"] = ss.pack_raw(raws, shape=shape)
                for form, batch in forms.items():
                    eager = step(st, batch.to(dev))
                    got = server._predict(form, shape, batch)
                    if form == "raw":
                        answers_equal(f"{name} raw overflow", got[1].int(),
                                      eager[1].int())
                        eager, got = eager[0], got[0]
                    out[f"{name}/{form}/{shape.graph_cap}"] = answers_equal(
                        f"{name} {form} rung {shape}", got, eager)
            c = server.stats()["counts"]
            check(c["captures_after_warm"] == 0,
                  f"{name} server captured after warm-up: {c}")
            out[f"{name}/graph_captures"] = c["graph_captures"]
        finally:
            check(server.drain(timeout_s=60), "the serve worker did not drain")
    check(any(k.startswith("dense/compact") for k in out)
          and any(k.startswith("dense/raw") for k in out)
          and any(k.startswith("coo/full") for k in out),
          f"not every form was replayed: {sorted(out)}")
    print(f"serve replays vs eager: {json.dumps(out, allow_nan=False)}")
    return out


def step_graphs_phase(dev, work_dir, calibration, coo_weights, card):
    """The step_graphs phase: the train entry point under the epoch
    driver (paths driver_compact, driver_full, driver_coo), the driver's
    trajectory against the eager loop, the default compact 3-bucket
    driver against its eager twin and full staging, its training rate
    against the eager per-step loop in turns, and every serving form
    replayed against eager. -> (summary, counts, the MP-like split)."""
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.compact import CompactSpec
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_mp,
        train_val_test_split,
    )

    counts = {}
    summary = {"card": card}
    summary["entry_point"] = driver_entry_runs(dev, work_dir, counts)
    t0 = time.perf_counter()
    mp = load_synthetic_mp(N_DRIVER, seed=SEED + 5)
    split = train_val_test_split(mp, 0.8, 0.1, seed=SEED)
    print(f"step_graphs: featurized {N_DRIVER} MP-like structures in "
          f"{time.perf_counter() - t0!r} s")
    summary["trajectory"] = driver_trajectory(dev, split)
    spec = CompactSpec.build(mp, DataConfig().featurize_config().gdf(),
                             dense_m=M)
    summary["compact_trajectory"] = driver_compact_trajectory(dev, split,
                                                              spec)
    summary["rate_pairs"] = driver_rate_pairs(dev, split, spec)
    summary["serve_replays"] = serve_replays(dev, work_dir, calibration,
                                             coo_weights)
    return summary, counts, split


# the resilience phase: the divergence guard inside the replayed train
# graphs, rollback with a cut rate, preemption and fault injection
GUARD_EPOCHS = 3  # the guard's no-op and rate runs (rates over epochs 2-3)
PREEMPT_EPOCHS = 120  # the preempted entry point's run: long enough that
# the SIGTERM sent at its first commit lands mid-run


class RequestAfterPolls:
    """A preemption request that reads as set from its (n+1)-th poll on:
    a signal landing while the n-th chunk runs (``arm`` sets n from the
    polls so far)."""

    def __init__(self, n=10**9):
        self.polls, self.n = 0, n

    def arm(self, more: int) -> None:
        self.n = self.polls + more

    @property
    def requested(self):
        self.polls += 1
        return self.polls > self.n


def fault_plan(spec):
    """Install a fresh fault plan (its counters at 0); None clears it."""
    from cgnn_tpu_torch.resilience import faultinject

    faultinject.set_plan(None if spec is None
                         else faultinject.FaultPlan.parse(spec))


def device_count(state) -> int:
    return int(state.optimizer.tensors()[0])


def skips_by_epoch(history) -> list:
    from cgnn_tpu_torch.resilience.guard import skipped_steps

    return [skipped_steps(h["train"]) for h in history]


def resilient_fit(dev, split, path=None, counts=None, model_kw=None,
                  extra_train_runs=0, **kw):
    """``fit`` at full width from a fresh seeded state (the kernel path
    unless ``model_kw`` says otherwise), traced as path ``path`` when one
    is named: each train and eval batch one run of its step graph (plus
    ``extra_train_runs``, the steps of an epoch stopped mid-way) ->
    (state, result, wall seconds)."""
    import torch

    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    model_kw = {"cgconv_impl": "pallas"} if model_kw is None else model_kw
    cfg, state, node_cap, edge_cap = new_state(dev, train_g, **model_kw)
    coo = cfg.dense_m == 0
    args = dict(epochs=GUARD_EPOCHS, batch_size=BATCH,
                dense_m=None if coo else M, device=dev, node_cap=node_cap,
                edge_cap=edge_cap if coo else None, seed=SEED,
                log_fn=lambda s: None) | kw
    t0 = time.perf_counter()
    if path is None:
        state, res = fit(state, train_g, val_g, **args)
    else:
        with PathRun(path) as run:
            state, res = fit(state, train_g, val_g, **args)
        hist = res["history"]
        counts[path] = check_path(
            run, coo_per_step(cfg.n_conv) if coo
            else dense_per_step(cfg.n_conv),
            {"train": sum(h["train"]["steps"] for h in hist)
             + extra_train_runs,
             "eval": sum(h["val"]["steps"] for h in hist)})
    torch.cuda.synchronize()
    return state, res, time.perf_counter() - t0


def guard_noop(dev, split, counts):
    """The epoch driver (one bucket, 3 epochs) with the guard and without
    it, from the same weights: every tensor bit-equal, no step skipped, no
    capture after warm-up; the guarded run traced (path
    ``guard_driver``); then untraced in turns off, on, on, off for the
    rate over epochs 2-3."""
    train_g = split[0]
    runs = {}
    for guard, path in ((True, "guard_driver"), (False, None),
                        (True, None), (True, None), (False, None)):
        state, res, wall = resilient_fit(dev, split, path, counts,
                                         scan_epochs=True, guard=guard)
        hist = res["history"]
        check(res["graphs"]["captures_after_warm"] == 0
              and (not guard or skips_by_epoch(hist) == [0] * len(hist))
              and state.optimizer.count == device_count(state),
              f"guard no-op (guard={guard}): graphs {res['graphs']}, skips "
              f"{skips_by_epoch(hist)}, count {state.optimizer.count} vs "
              f"{device_count(state)}")
        key = "on" if guard else "off"
        if key not in runs:
            runs[key] = state_bits(state)
        rate = steady_rate(hist, len(train_g))
        runs.setdefault(f"{key}_structures_per_s", []).append(
            {"traced": path is not None, "rate": rate})
        print(f"guard no-op: guard {key}{' (traced)' if path else ''}: "
              f"{rate!r} train structures/s over epochs 2-3")
    equal, worst, where = bits_diff(runs.pop("on"), runs.pop("off"))
    check(equal, f"guard no-op: the guarded driver's trajectory leaves the "
                 f"unguarded one ({worst!r} at {where})")
    return runs | {"bit_equal": equal}


def guard_nan_loop(dev, train_g, counts, poisoned=2, k=5):
    """The per-step loop with graphs (``StepRunner``, one graph for the
    batches' shape) on k fixed batches with batch ``poisoned`` NaN: the
    kernel path (traced, path ``guard_nan_loop``) bit-equal to a run that
    never saw that batch, and its skipped steps those of the plain path;
    the host count settled to the device count."""
    from cgnn_tpu_torch.resilience import faultinject
    from cgnn_tpu_torch.resilience.guard import guard_step
    from cgnn_tpu_torch.train.loop import StepRunner, settle_count
    from cgnn_tpu_torch.train.step import make_train_step

    def run(model_kw, batches, path=None):
        cfg, state, node_cap, _ = new_state(dev, train_g, **model_kw)
        runner = StepRunner(guard_step(make_train_step()), state, dev,
                            train=True)
        flags = []

        def steps():
            for b in batches:
                m = runner.epoch([b])
                settle_count(state, m)
                flags.append(round(m["guard_skipped"]))

        if path is None:
            steps()
        else:
            with PathRun(path) as prun:
                steps()
            counts[path] = check_path(prun, dense_per_step(cfg.n_conv),
                                      {"train": len(batches)})
        check(state.optimizer.count == device_count(state)
              and runner.cache.captures() == int(dev.type == "cuda"),
              f"guard_nan_loop: count {state.optimizer.count} vs "
              f"{device_count(state)}, captures {runner.cache.captures()}")
        return state_bits(state), flags

    _, _, node_cap, _ = new_state(dev, train_g)
    clean = fixed_batches(dev, train_g, node_cap, k)
    dirty = [faultinject.poison_nan(b) if i == poisoned else b
             for i, b in enumerate(clean)]
    bits_k, flags_k = run({"cgconv_impl": "pallas"}, dirty, "guard_nan_loop")
    bits_skip, _ = run({"cgconv_impl": "pallas"},
                       [b for i, b in enumerate(clean) if i != poisoned])
    _, flags_p = run({}, dirty)
    want = [int(i == poisoned) for i in range(k)]
    equal, worst, where = bits_diff(bits_k, bits_skip)
    check(flags_k == flags_p == want and equal,
          f"guard_nan_loop: skips kernel {flags_k} plain {flags_p} (want "
          f"{want}); against the run without batch {poisoned}: bit-equal "
          f"{equal} ({worst!r} at {where})")
    return {"skips_kernel": flags_k, "skips_plain": flags_p,
            "bit_equal_to_run_without_the_batch": equal}


def poison_feature(batch, where):
    """``batch`` with one NaN in the features of its first real node
    (``where='node'``) or of its first real edge (``'edge'``); its
    targets stay finite, so only a kernel that carries the NaN on makes
    the loss non-finite."""
    import torch

    if where == "node":
        nodes = batch.nodes.clone()
        nodes[int(torch.nonzero(batch.node_mask)[0]), 0] = float("nan")
        return dataclasses.replace(batch, nodes=nodes)
    edges = batch.edges.clone()
    slot = int(torch.nonzero(batch.edge_mask)[0])
    edges.view(-1, edges.shape[-1])[slot, 0] = float("nan")
    return dataclasses.replace(batch, edges=edges)


def guard_nan_features(dev, train_g, counts, k=4):
    """One NaN in a node's features (batch 1) and in an edge's (batch 2),
    the targets finite, dense through kernels 1, 2, 4, 5 and COO through
    kernel 6, each beside its plain path: a kernel that drops a NaN gives
    a finite loss where the plain path's is NaN. On each poisoned batch,
    one unguarded eager train step from fresh weights: its loss and the
    non-finite elements of each updated parameter equal the plain path's
    (NaN loss on both). Then the guarded per-step loop with graphs over
    the k batches (the kernel path traced, paths ``guard_nan_features``
    and ``guard_nan_features_coo``): the same steps skipped on both
    paths, and only the poisoned ones."""
    import math

    import torch

    from cgnn_tpu_torch.resilience.guard import guard_step
    from cgnn_tpu_torch.train.loop import StepRunner, settle_count
    from cgnn_tpu_torch.train.step import make_train_step

    out = {}
    for label, path, kernel_kw, plain_kw in (
            ("dense", "guard_nan_features", {"cgconv_impl": "pallas"}, {}),
            ("coo", "guard_nan_features_coo",
             {"dense_m": 0, "aggregation": COO_AGG},
             {"dense_m": 0, "aggregation": "xla"})):
        cfg, _, node_cap, edge_cap = new_state(dev, train_g, **kernel_kw)
        clean = fixed_batches(dev, train_g, node_cap, k, edge_cap=edge_cap,
                              dense_m=cfg.dense_m or None)
        batches = list(clean)
        batches[1] = poison_feature(clean[1], "node")
        batches[2] = poison_feature(clean[2], "edge")
        per_step = (coo_per_step(cfg.n_conv) if cfg.dense_m == 0
                    else dense_per_step(cfg.n_conv))
        res = {}
        for impl, kw in (("kernel", kernel_kw), ("plain", plain_kw)):
            unguarded = []
            for i in (1, 2):
                _, state, _, _ = new_state(dev, train_g, **kw)
                loss = float(make_train_step()(state, batches[i])[
                    "loss_sum"])
                unguarded.append({
                    "loss_finite": math.isfinite(loss),
                    "nonfinite_params": {
                        n: int((~torch.isfinite(p)).sum())
                        for n, p in state.model.named_parameters()}})
            _, state, _, _ = new_state(dev, train_g, **kw)
            runner = StepRunner(guard_step(make_train_step()), state, dev,
                                train=True)
            flags = []

            def steps():
                for b in batches:
                    m = runner.epoch([b])
                    settle_count(state, m)
                    flags.append(round(m["guard_skipped"]))

            if impl == "kernel":
                with PathRun(path) as prun:
                    steps()
                counts[path] = check_path(prun, per_step, {"train": k})
            else:
                steps()
            check(state.optimizer.count == device_count(state) == k - 2,
                  f"guard_nan_features {label} {impl}: count "
                  f"{state.optimizer.count} vs {device_count(state)} (want "
                  f"{k - 2})")
            res[impl] = {"unguarded": unguarded, "skips": flags}
        want = [int(i in (1, 2)) for i in range(k)]
        check(res["kernel"]["unguarded"] == res["plain"]["unguarded"]
              and not any(u["loss_finite"]
                          for u in res["plain"]["unguarded"])
              and res["kernel"]["skips"] == res["plain"]["skips"] == want,
              f"guard_nan_features {label}: kernel {res['kernel']} plain "
              f"{res['plain']} (want NaN losses, the same non-finite "
              f"parameters and skips {want} on both paths)")
        out[label] = {impl: {"skips": r["skips"],
                             "loss_finite": [u["loss_finite"]
                                             for u in r["unguarded"]]}
                      for impl, r in res.items()}
    print(f"guard_nan_features: {json.dumps(out, allow_nan=False)}")
    return out


def guard_nan_driver(dev, split, counts):
    """``nan_batch=1`` under the epoch driver: the staged poisoned batch is
    skipped once every epoch, losses finite, host count equal to the
    device count, no capture after warm-up; dense with kernels 1, 2, 4, 5
    (path ``guard_nan_driver``) and COO with kernel 6
    (``guard_nan_coo``), each beside its plain path's skips."""
    import math

    out = {}
    for label, path, kernel_kw, plain_kw in (
            ("dense", "guard_nan_driver", {"cgconv_impl": "pallas"}, {}),
            ("coo", "guard_nan_coo", {"dense_m": 0, "aggregation": COO_AGG},
             {"dense_m": 0, "aggregation": "xla"})):
        skips = {}
        for impl, kw, traced in (("kernel", kernel_kw, True),
                                 ("plain", plain_kw, False)):
            fault_plan("nan_batch=1")
            try:
                state, res, _ = resilient_fit(
                    dev, split, path if traced else None, counts,
                    model_kw=kw, scan_epochs=True, guard=True)
            finally:
                fault_plan(None)
            hist = res["history"]
            skips[impl] = skips_by_epoch(hist)
            check(all(math.isfinite(h["train"]["loss"]) for h in hist)
                  and state.optimizer.count == device_count(state)
                  and res["graphs"]["captures_after_warm"] == 0,
                  f"guard_nan_driver {label} {impl}: losses "
                  f"{[h['train']['loss'] for h in hist]}, count "
                  f"{state.optimizer.count} vs {device_count(state)}, "
                  f"graphs {res['graphs']}")
        want = [1] * GUARD_EPOCHS
        check(skips["kernel"] == skips["plain"] == want,
              f"guard_nan_driver {label}: skips by epoch {skips} (want "
              f"{want} on both paths)")
        out[label] = skips
    return out


def guard_rollback(dev, split, work_dir, counts):
    """--guard rollback with --guard-max-skips 1 under the epoch driver, the
    poisoned batch staged (it recurs every epoch): epoch 0 has no
    checkpoint to go back to and is saved; epochs 1 and 2 roll back to it,
    each cutting the rate by 0.5 in place (the table keeps its address, no
    capture after warm-up; path ``guard_rollback``). Every save's meta
    carries the monitor's progress; a run resumed from a save made after
    the rollbacks reapplies the cut; one more epoch spends the budget
    (``DivergenceError``)."""
    import shutil

    import torch

    from cgnn_tpu_torch.resilience.guard import (
        DivergenceError,
        DivergenceMonitor,
    )
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    ck = os.path.join(work_dir, "rollback_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    ckpt = CheckpointManager(ck, log_fn=lambda s: None)
    metas, tables = [], []
    mon = DivergenceMonitor(ckpt, max_skips=1, lr_cut=0.5, max_rollbacks=2,
                            log_fn=lambda s: print(f"guard_rollback: {s}"))

    def save(s, epoch, val_m, is_best):
        tables.append(s.optimizer._lr_table.data_ptr())
        metas.append({"epoch": epoch, **mon.meta()})
        ckpt.save(s, metas[-1], is_best=is_best)

    def cut_table(opt, scale):
        return torch.tensor([v * scale for v in opt.schedule.table()],
                            dtype=opt._lr_table.dtype)

    try:
        fault_plan("nan_batch=1")
        state, res, _ = resilient_fit(dev, split, "guard_rollback", counts,
                                      scan_epochs=True, guard=True,
                                      monitor=mon, on_epoch_end=save)
        opt = state.optimizer
        check(mon.rollbacks == 2 and opt.lr_scale == 0.25
              and opt._lr_table.data_ptr() == tables[0]
              and torch.equal(opt._lr_table.cpu(), cut_table(opt, 0.25))
              and res["graphs"]["captures_after_warm"] == 0
              and metas == [{"epoch": 0, "guard_lr_scale": 1.0,
                             "guard_rollbacks": 0}]
              and skips_by_epoch(res["history"]) == [1] * GUARD_EPOCHS,
              f"guard_rollback: rollbacks {mon.rollbacks}, lr scale "
              f"{opt.lr_scale}, table {opt._lr_table.tolist()}, graphs "
              f"{res['graphs']}, metas {metas}")
        graphs = res["graphs"]
        # a save after the rollbacks (what the next good epoch writes),
        # then a resumed run: the cut comes back from the meta
        save(state, GUARD_EPOCHS - 1, {}, False)
        ckpt.wait()
        _, fresh, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
        table = fresh.optimizer._lr_table.data_ptr()
        _, meta = ckpt.restore(fresh)
        mon2 = DivergenceMonitor(ckpt, max_skips=1, lr_cut=0.5,
                                 max_rollbacks=2, log_fn=lambda s: None)
        mon2.resume_from_meta(fresh, meta)
        check(meta["guard_lr_scale"] == 0.25 and meta["guard_rollbacks"] == 2
              and fresh.optimizer.lr_scale == 0.25 and mon2.rollbacks == 2
              and fresh.optimizer._lr_table.data_ptr() == table
              and torch.equal(fresh.optimizer._lr_table.cpu(),
                              cut_table(fresh.optimizer, 0.25)),
              f"guard_rollback resume: meta {meta}, lr scale "
              f"{fresh.optimizer.lr_scale}")
        fault_plan("nan_batch=1")
        spent = False
        try:
            fit(fresh, train_g, val_g, epochs=GUARD_EPOCHS + 1,
                start_epoch=GUARD_EPOCHS, batch_size=BATCH, dense_m=M,
                device=dev, node_cap=node_cap, seed=SEED,
                log_fn=lambda s: None, scan_epochs=True, guard=True,
                monitor=mon2)
        except DivergenceError as e:
            spent = "2 rollbacks already spent" in str(e)
        check(spent, "guard_rollback: the spent budget did not raise "
                     "DivergenceError")
    finally:
        fault_plan(None)
        ckpt.close()
    out = {"rollbacks": mon.rollbacks, "lr_scale": opt.lr_scale,
           "metas": metas, "graphs": graphs, "resumed_meta": {
               k: meta[k] for k in ("epoch", "guard_lr_scale",
                                    "guard_rollbacks")},
           "budget_spent_raises": spent}
    print(f"guard_rollback: {json.dumps(out, allow_nan=False)}")
    return out


def preempt_in_process(dev, split, work_dir, counts):
    """A preemption request polled by the epoch driver (7 train steps an
    epoch, chunks of 2): armed at epoch 0's save, it turns true at epoch
    1's second chunk boundary, so epoch 1 stops after 2 steps, its eval
    skipped; fit saves the current weights under epoch 0 and returns
    ``preempted`` (path ``preempt_driver``); the host count equals the
    device count, 2 past epoch 0's."""
    import shutil

    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    ck = os.path.join(work_dir, "preempt_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    ckpt = CheckpointManager(ck, log_fn=lambda s: None)
    pre = RequestAfterPolls()
    saved = []

    def save(s, epoch, val_m, is_best):
        saved.append(epoch)
        ckpt.save(s, {"epoch": epoch}, is_best=is_best)
        if epoch == 0:  # the epoch-end poll, then epoch 1's first chunk
            pre.arm(2)

    try:
        # the stopped epoch's train steps: one chunk of chunk_steps (2)
        state, res, _ = resilient_fit(
            dev, split, "preempt_driver", counts, extra_train_runs=2,
            scan_epochs=True, guard=True, preempt=pre, on_epoch_end=save)
        ckpt.wait()
        meta = ckpt.read_meta()
    finally:
        ckpt.close()
    hist = res["history"]
    first = hist[0]["train"]["steps"] if hist else None
    check(res.get("preempted") is True and [h["epoch"] for h in hist] == [0]
          and saved == [0, 0] and meta["epoch"] == 0
          and state.optimizer.count == device_count(state) == first + 2,
          f"preempt_driver: result {res.get('preempted')}, epochs "
          f"{[h['epoch'] for h in hist]}, saves {saved}, meta {meta}, count "
          f"{state.optimizer.count} vs {device_count(state)}")
    return {"stopped_epoch": 1, "steps_run_in_it": 2, "saved_epochs": saved,
            "count": state.optimizer.count}


def preempt_entry_point(dev, work_dir, extra_argv=()):
    """The train entry point in a subprocess as a user runs it
    (--device-resident, --synthetic 640, batch 256, the kernel path):
    SIGTERM at its first commit -> exit 75 with a resumable save; then
    --resume auto with ``crash=after_write:1:exit`` dies with 137 at its
    first save, and the save before it still restores; then --resume auto
    completes the run to its last epoch."""
    import glob
    import shutil
    import signal

    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    root = os.path.dirname(os.path.abspath(__file__))
    ck = os.path.join(work_dir, "preempt_entry_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = [sys.executable, "-m", "cgnn_tpu_torch.train", "--synthetic",
            str(N_TRAIN_SET), "--device-resident", "-b", str(BATCH),
            "--epochs", str(PREEMPT_EPOCHS), "--cgconv-impl", "pallas",
            "--print-freq", "0", "--seed", str(SEED), "--ckpt-dir", ck,
            "--out-dir", os.path.join(work_dir, "preempt_entry_out"),
            *extra_argv]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("CGNN_TPU_FAULTS", None)

    def finish(proc, label):
        out, err = proc.communicate(timeout=600)
        for line in out.splitlines()[-6:]:
            print(f"{label}: {line}")
        return proc.returncode, out, err

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 600
        while not glob.glob(os.path.join(ck, "ckpt-*", "MANIFEST.json")):
            check(proc.poll() is None and time.time() < deadline,
                  f"preempt_entry: no commit (exit {proc.poll()})")
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        rc, out, err = finish(proc, "preempt_entry")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    mgr = CheckpointManager(ck)
    try:
        preempted_at = mgr.read_meta()["epoch"]
    finally:
        mgr.close()
    check(rc == 75 and "preempted: resumable checkpoint saved" in out
          and preempted_at < PREEMPT_EPOCHS - 1,
          f"preempt_entry: exit {rc} (want 75), saved epoch {preempted_at}; "
          f"{err[-1500:]}")
    crash = subprocess.run(argv + ["--resume", "auto"], cwd=root,
                           env=dict(env, CGNN_TPU_FAULTS=
                                    "crash=after_write:1:exit"),
                           capture_output=True, text=True, timeout=600)
    mgr = CheckpointManager(ck)
    try:
        survivor = mgr.read_meta()["epoch"]
    finally:
        mgr.close()
    check(crash.returncode == 137 and "FAULT INJECTION ACTIVE" in crash.stderr
          and survivor == preempted_at,
          f"preempt_entry crash: exit {crash.returncode} (want 137), newest "
          f"save epoch {survivor} (want {preempted_at}); "
          f"{crash.stderr[-1500:]}")
    resume = subprocess.Popen(argv + ["--resume", "auto"], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    rc2, out2, err2 = finish(resume, "preempt_entry_resume")
    check(rc2 == 0 and f"at epoch {preempted_at + 1}" in out2
          and f"Epoch {PREEMPT_EPOCHS - 1}:" in out2,
          f"preempt_entry resume: exit {rc2}; {err2[-1500:]}")
    return {"preempted_after_epoch": preempted_at, "exit": rc,
            "crash_exit": crash.returncode, "resume_exit": rc2,
            "wall_s": time.perf_counter() - t0}


def coo_repeats(dev, split, work_dir):
    """COO training (kernel 6, the epoch driver) run twice from the same
    weights, and resumed from a checkpoint against the in-memory state,
    without deterministic algorithms: bit-equal in every tensor (else it
    fails with the largest difference and where it is)."""
    import shutil

    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    coo = {"dense_m": 0, "aggregation": COO_AGG}

    def run(state, node_cap, edge_cap, epochs, start=0):
        return fit(state, train_g, val_g, epochs=epochs, start_epoch=start,
                   batch_size=BATCH, dense_m=None, device=dev,
                   node_cap=node_cap, edge_cap=edge_cap, seed=SEED,
                   log_fn=lambda s: None, scan_epochs=True)[0]

    twice = []
    for _ in range(2):
        _, state, nc, ec = new_state(dev, train_g, **coo)
        twice.append(state_bits(run(state, nc, ec, 2)))
    rep_equal, rep_worst, rep_where = bits_diff(*twice)
    ck = os.path.join(work_dir, "coo_resume_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    ckpt = CheckpointManager(ck, log_fn=lambda s: None)
    try:
        _, state, nc, ec = new_state(dev, train_g, **coo)
        state = run(state, nc, ec, 1)
        ckpt.save(state, {"epoch": 0})
        _, restored, _, _ = new_state(dev, train_g, **coo)
        ckpt.restore(restored)
    finally:
        ckpt.close()
    resumed = state_bits(run(restored, nc, ec, 2, start=1))
    in_memory = state_bits(run(state, nc, ec, 2, start=1))
    res_equal, res_worst, res_where = bits_diff(resumed, in_memory)
    check(rep_equal and res_equal,
          f"coo_repeats: run twice bit-equal {rep_equal} ({rep_worst!r} at "
          f"{rep_where}), resumed bit-equal {res_equal} ({res_worst!r} at "
          f"{res_where})")
    out = {"repeat_bit_equal": rep_equal, "repeat_max_diff": rep_worst,
           "repeat_worst": rep_where, "resume_bit_equal": res_equal,
           "resume_max_diff": res_worst, "resume_worst": res_where}
    print(f"coo_repeats: {json.dumps(out, allow_nan=False)}")
    return out


def resilience_phase(dev, work_dir, split, mp_split):
    """The resilience phase (module docstring) -> (summary, counts)."""
    counts = {}
    t0 = time.perf_counter()
    summary = {"noop": guard_noop(dev, mp_split, counts)}
    summary["nan_loop"] = guard_nan_loop(dev, split[0], counts)
    summary["nan_driver"] = guard_nan_driver(dev, split, counts)
    summary["nan_features"] = guard_nan_features(dev, split[0], counts)
    summary["rollback"] = guard_rollback(dev, split, work_dir, counts)
    summary["preempt_driver"] = preempt_in_process(dev, mp_split, work_dir,
                                                   counts)
    summary["preempt_entry"] = preempt_entry_point(dev, work_dir)
    summary["coo_repeats"] = coo_repeats(dev, split, work_dir)
    summary["wall_s"] = time.perf_counter() - t0
    return summary, counts


N_DP = 2048  # the data_parallel phase's MP-like structures (a graph cache)
DP_WORLD = 2  # its ranks, sharing the one card over gloo
DP_EPOCHS = 3
DP_RANK_TIMEOUT_S = 300.0  # a rank's wall bound: killed past it, phase fails
DP_RTOL = 1e-5  # two ranks vs the one-process emulation, per-epoch metrics
# the train entry point run in a process under PathRun (traced_train)
TRACED_TRAIN = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.traced_train(sys.argv[1], sys.argv[2:]))")


def traced_train(out_path, argv) -> int:
    """``python -m cgnn_tpu_torch.train ARGV`` in this process inside a
    ``PathRun`` (this rank's card set first), its output captured and
    echoed, written with the run's launches and step counters to
    ``out_path`` as JSON -> its exit code."""
    import contextlib
    import io

    import torch

    from cgnn_tpu_torch.parallel import dist
    from cgnn_tpu_torch.train.__main__ import main as train_main

    cfg = dist.configured_env()
    if cfg is not None:
        torch.cuda.set_device(cfg["process_id"] % torch.cuda.device_count())
    buf = io.StringIO()
    trace = record_driver_trace()
    with PathRun("train") as run:
        with contextlib.redirect_stdout(buf):
            rc = train_main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "launches": run.launches, "wrapper": run.wrapper,
                   "steps": run.steps, "out": out, "driver_trace": trace},
                  f, allow_nan=False)
    return rc


def record_driver_trace() -> list:
    """Every epoch driver ``fit`` makes in this process from here on
    records its run into the list returned: ``"epoch"`` at each epoch
    pair, then ``[train, shape key, batch indices]`` for every chunk, in
    the order run (the driver's host mirrors), for ``dp_emulation``."""
    from cgnn_tpu_torch.train import loop

    out = []
    base = loop.ScanEpochDriver

    class Traced(base):
        def _run_chunk(self, key, grp, length, train):
            out.append([bool(train), key, grp.host_perm[
                grp.host_cursor:grp.host_cursor + length].tolist()])
            return super()._run_chunk(key, grp, length, train)

        def run_epoch_pair(self, state, first, **kw):
            out.append("epoch")
            return super().run_epoch_pair(state, first, **kw)

    loop.ScanEpochDriver = Traced
    return out


class DataParallelRun:
    """``world`` ranks (``DP_WORLD`` by default) of the train entry point
    (``traced_train``, the environment triple, the coordinator on a free
    localhost port), rank r with ``--ckpt-dir``/``--out-dir`` of its own
    under ``<work_dir>/<label>``; ``rank_env`` adds variables to one
    rank's environment. ``wait`` bounds every rank by
    ``DP_RANK_TIMEOUT_S`` and kills all of them on a failure or a hang;
    ``kill`` stops them whatever their state."""

    def __init__(self, label, work_dir, argv, rank_env=None,
                 world=DP_WORLD, fresh=True):
        import shutil

        from cgnn_tpu_torch.parallel import dist

        self.label = label
        self.world = world
        self.dir = os.path.join(work_dir, label)
        if fresh:  # else the last run's directories stay (a resume)
            shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        root = os.path.dirname(os.path.abspath(__file__))
        coord = f"localhost:{free_port()}"
        self.procs, self._logs = [], []
        self.t0 = time.perf_counter()
        for r in range(world):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("CGNN_TPU_")}
            env.update(dist.env_for(coord, world, r),
                       PYTHONPATH=root, **(rank_env or {}).get(r, {}))
            log = open(os.path.join(self.dir, f"rank{r}.log"), "w")
            self._logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", TRACED_TRAIN, self.trace_path(r),
                 *argv, "--ckpt-dir", self.ckpt(r), "--out-dir",
                 os.path.join(self.dir, f"out-rank{r}")],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))

    def kill(self) -> None:
        """Every rank still running killed and reaped; the logs closed."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self._logs:
            log.close()

    def trace_path(self, r) -> str:
        return os.path.join(self.dir, f"rank{r}.trace.json")

    def ckpt(self, r) -> str:
        return os.path.join(self.dir, f"ckpt-rank{r}")

    def wait(self, expect=0) -> list:
        """Every rank's trace (``traced_train``'s JSON) with its wall;
        every rank must exit ``expect``."""
        deadline = self.t0 + DP_RANK_TIMEOUT_S
        try:
            # a rank that failed leaves the others blocked in a
            # collective until the group's timeout: stop them at once
            while (any(p.poll() is None for p in self.procs)
                   and not any(p.poll() not in (None, expect)
                               for p in self.procs)
                   and time.perf_counter() < deadline):
                time.sleep(0.2)
        finally:
            self.kill()
        wall = time.perf_counter() - self.t0
        codes = [p.returncode for p in self.procs]
        for r in range(self.world):
            tail = open(os.path.join(self.dir, f"rank{r}.log")).read()
            for line in tail.splitlines()[-40:] if codes[r] else []:
                print(f"{self.label} rank {r}: {line}")
        check(codes == [expect] * self.world,
              f"{self.label}: ranks exited {codes}, want {expect} (a hung "
              f"rank is killed after {DP_RANK_TIMEOUT_S} s)")
        traces = []
        for r in range(self.world):
            with open(self.trace_path(r)) as f:
                t = json.load(f)
            t["info"] = json.loads(next(
                (line for line in t["out"].splitlines()
                 if line.startswith("train: ")), "train: {}")[7:])
            t["wall_s"] = wall
            traces.append(t)
        return traces


def dp_logical(info) -> dict:
    """A rank's steps from its ``train:`` record: each train step one run
    of graph A (``train``) and one of graph B (``train_apply``); each
    validation step, padding included, and each test batch one eval
    run."""
    train = sum(info["train_steps"])
    return {"train": train, "train_apply": train,
            "eval": sum(info["eval_steps"]) + info["test"]["steps"]}


def dp_hold(label, traces, per_step, counts, epochs=DP_EPOCHS,
            captured=True) -> dict:
    """The ranks of one leg held together: rc 0, equal state digests
    after every one of ``epochs`` epochs, the same steps and test
    metrics, no capture after warm-up (and, ``captured``, some capture;
    a graph-sharded step runs eagerly: none), each rank's launches exact
    (``check_path``, path ``<label>.rank<r>``) -> the leg's record."""
    infos = [t["info"] for t in traces]
    digests = [i["dp"]["digests"] for i in infos]
    check(all(d == digests[0] for d in digests)
          and len(digests[0]) == epochs,
          f"{label}: the ranks' digests differ: {digests}")
    # the summed metrics are the same bits on every rank; the test
    # split's, evaluated by each rank alone, may differ in the last bits
    for key in ("train_steps", "eval_steps", "guard_skipped", "train_loss",
                "val_metric"):
        check(all(i[key] == infos[0][key] for i in infos),
              f"{label}: the ranks' {key} differ: "
              f"{[i[key] for i in infos]}")
    for r, (t, i) in enumerate(zip(traces, infos)):
        check(i["graphs"]["captures_after_warm"] == 0
              and (i["graphs"]["captures"] > 0) == captured,
              f"{label} rank {r}: graphs {i['graphs']}")
        run = types.SimpleNamespace(label=f"{label}.rank{r}",
                                    launches=t["launches"],
                                    wrapper=t["wrapper"], steps=t["steps"])
        counts[run.label] = check_path(run, per_step, dp_logical(i))
    return {"digests": digests[0], "train_steps": infos[0]["train_steps"],
            "eval_steps": infos[0]["eval_steps"],
            "guard_skipped": infos[0]["guard_skipped"],
            "train_loss": infos[0]["train_loss"],
            "val_mae": infos[0]["val_metric"], "test": infos[0]["test"],
            "graphs": [i["graphs"] for i in infos],
            "train_structures_per_s_by_rank": [
                i["train_structures_per_s"] for i in infos],
            "epoch_seconds_by_rank": [i["epoch_seconds"] for i in infos],
            "edge_bytes_by_rank": [i.get("edge_bytes") for i in infos],
            "wall_s": traces[0]["wall_s"]}


def dp_committer(leg, r0_ckpt, other_dirs, epochs=DP_EPOCHS) -> None:
    """Process 0 committed every epoch; no other rank wrote a directory."""
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(r0_ckpt)
    saved = mgr.exists() and mgr.read_meta().get("epoch") == epochs - 1
    mgr.close()
    stray = [d for d in other_dirs if os.path.exists(d)]
    check(saved and not stray,
          f"{leg}: process 0's checkpoint committed {saved}; written by "
          f"other ranks: {stray}")


def driver_lists(shards, full, dense_m, nc, ec, rngs, *, train, buckets,
                 force=False) -> list:
    """Each rank's batches as ``fit`` packs them once for the epoch
    driver under a process group (its shard, its shuffle, the whole
    split's shapes: ``fit_on``), agreed as the ranks agree them
    (``agree_lists``) -> per rank {JSON shape key: batches in order}."""
    from cgnn_tpu_torch.data.graph import (
        batch_iterator,
        batch_shape_key,
        bucketed_batch_iterator,
        graph_cap_for,
        overflow_cap,
    )
    from cgnn_tpu_torch.parallel.data_parallel import agree_lists

    in_cap = None if (train or force) else 0
    over = (overflow_cap(full, graph_cap_for(BATCH), dense_m)
            if dense_m and in_cap is None else None)
    lists = []
    for r, shard in enumerate(shards):
        kw = dict(shuffle=True, rng=rngs[r]) if train else {}
        if buckets > 1:
            it = bucketed_batch_iterator(shard, BATCH, buckets,
                                         dense_m=dense_m, in_cap=in_cap,
                                         snug=True, fit_graphs=full, **kw)
        else:
            it = batch_iterator(shard, BATCH, nc, ec, dense_m=dense_m,
                                in_cap=in_cap, snug=True, over_cap=over,
                                **kw)
        lists.append(list(it))
    out = []
    for batches in agree_lists(lists, train):
        groups: dict = {}
        for b in batches:
            groups.setdefault(json.dumps(batch_shape_key(b), allow_nan=False),
                              []).append(b)
        out.append(groups)
    return out


def trace_epochs(trace) -> list:
    """A rank's ``record_driver_trace`` -> per epoch, its chunks
    ``(train, JSON shape key, indices)`` in the order run."""
    epochs = []
    for entry in trace:
        if entry == "epoch":
            epochs.append([])
        else:
            epochs[-1].append((entry[0], json.dumps(entry[1], allow_nan=False),
                               entry[2]))
    return epochs


def dp_emulation(dev, graphs, model_kw, guard=True, *, node_cap=None,
                 epochs=DP_EPOCHS, world=DP_WORLD, force=False, trace=None,
                 buckets=1) -> dict:
    """``world`` data-parallel ranks' run in one process on the card: the
    same split, host shards, per-rank shuffles and capacities as the
    entry point (``node_cap`` where the run was given one), the same
    kernels, each step's grad part run for rank 0's batch, then rank
    1's, ... (the BatchNorm statistics put back between them), the
    buckets summed as the collective sums them and applied once; each
    rank's validation batches padded as the ranks pad them and the sums
    added up -> per-epoch train loss and val MAE. ``force``: the force
    task as ``--task force --optim Adam --lr 0.002`` trains it (the
    trajectory split, its grad and eval steps, the validation batches
    with their mapping; the val metric the force MAE). ``trace``: a
    rank's ``record_driver_trace`` of the epoch driver (``--device-
    resident``, ``buckets`` size classes): every batch packed once as
    the ranks pack and agree it (``driver_lists``), and each epoch's
    train and eval chunks run in the trace's order, every rank's batch
    at each index."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import train_val_test_split
    from cgnn_tpu_torch.data.graph import batch_iterator, count_batches
    from cgnn_tpu_torch.data.trajectory import split_trajectory_groups
    from cgnn_tpu_torch.parallel import dist
    from cgnn_tpu_torch.parallel.data_parallel import (
        ParallelTrainStep,
        parallel_batches,
    )
    from cgnn_tpu_torch.train.force_step import (
        make_force_eval_step,
        make_force_grad_step,
    )
    from cgnn_tpu_torch.train.loop import batch_caps
    from cgnn_tpu_torch.train.metrics import DeviceSums, fetch_device_sums
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import make_eval_step, make_grad_step

    if force:
        train_g, val_g, _ = split_trajectory_groups([graphs], 0.8, 0.1,
                                                    seed=SEED)
    else:
        train_g, val_g, _ = train_val_test_split(graphs, 0.8, 0.1,
                                                 seed=SEED)
    cfg = ModelConfig(**model_kw)
    dense_m = cfg.dense_m or None
    tshards = [dist.host_shard(train_g, r, world) for r in range(world)]
    vshards = [dist.host_shard(val_g, r, world) for r in range(world)]
    nc, ec = batch_caps(train_g, BATCH, dense_m, node_cap)
    per_epoch = min(count_batches(s, BATCH, nc, ec, snug=True)
                    for s in tshards)
    opt = dict(optim="Adam", lr=0.002) if force else {}
    state, nc, ec = init_train_state(cfg, DataConfig(), train_g,
                                     batch_size=BATCH, device=dev,
                                     seed=SEED, steps_per_epoch=per_epoch,
                                     node_cap=node_cap,
                                     task="force" if force else "regression",
                                     **opt)
    step = ParallelTrainStep(make_force_grad_step() if force
                             else make_grad_step(), reducer=None,
                             world=world, guard=guard)
    eval_step = make_force_eval_step() if force else make_eval_step()
    rngs = [np.random.default_rng(SEED) for _ in range(world)]
    buffers = [b for b in state.model.buffers() if b.is_floating_point()]
    out = {"train_loss": [], "val_mae": []}

    def train_step(batches) -> dict:
        """One step: each rank's grad part (the statistics put back
        between them), the buckets summed, applied once."""
        before = [b.clone() for b in buffers]
        total = None
        for b in batches:
            with torch.no_grad():
                if buffers:
                    torch._foreach_copy_(buffers, before)
            step.grad_part(state, b.to(dev))
            total = (step.bucket.clone() if total is None
                     else total + step.bucket)
        step.bucket.copy_(total)
        return step.apply_part(state)

    def means(tsums, vsums) -> None:
        with torch.no_grad():
            total = {k: sum(s.sums[k] for s in vsums) for k in vsums[0].sums}
        t, v = fetch_device_sums(tsums.sums), fetch_device_sums(total)
        out["train_loss"].append(t["loss_sum"] / t["count"])
        out["val_mae"].append(v["force_mae_sum"] / v["force_mae_count"]
                              if force else v["mae_sum"] / v["count"])

    if trace is not None:
        tgroups = driver_lists(tshards, train_g, dense_m, nc, ec, rngs,
                               train=True, buckets=buckets, force=force)
        vgroups = driver_lists(vshards, val_g, dense_m, nc, ec, rngs,
                               train=False, buckets=buckets, force=force)
        for chunks in trace_epochs(trace)[:epochs]:
            tsums, vsums = DeviceSums(), [DeviceSums() for _ in range(world)]
            for train, key, idx in chunks:
                for i in idx:
                    if train:
                        tsums.add(train_step([g[key][i] for g in tgroups]))
                    else:
                        for r in range(world):
                            vsums[r].add(eval_step(state,
                                                   vgroups[r][key][i].to(dev)))
            means(tsums, vsums)
        return out
    for _ in range(epochs):
        lists = [list(batch_iterator(tshards[r], BATCH, nc, ec, shuffle=True,
                                     rng=rngs[r], dense_m=dense_m,
                                     snug=True))
                 for r in range(world)]
        steps = min(map(len, lists))
        tsums = DeviceSums()
        for i in range(steps):
            tsums.add(train_step([lists[r][i] for r in range(world)]))
        vlists = [list(batch_iterator(vshards[r], BATCH, nc, ec,
                                      dense_m=dense_m,
                                      in_cap=None if force else 0,
                                      snug=True))
                  for r in range(world)]
        longest = max(map(len, vlists))
        vsums = [DeviceSums() for _ in range(world)]
        for r in range(world):
            for b in parallel_batches(vlists[r], train=False, steps=longest):
                vsums[r].add(eval_step(state, b.to(dev)))
        means(tsums, vsums)
    return out


def dp_against_emulation(label, leg, want, rtol=DP_RTOL, epochs=DP_EPOCHS,
                         what="the one-process emulation") -> dict:
    """A leg's per-epoch train loss and val MAE within ``rtol`` of the
    one-process emulation's (or another one-process run's, ``what``) ->
    the largest relative difference."""
    rel = max(abs(g - w) / max(abs(w), 1e-12)
              for key in ("train_loss", "val_mae")
              for g, w in zip(leg[key], want[key]))
    ok = (len(leg["train_loss"]) == len(want["train_loss"]) == epochs
          and rel <= rtol)
    print(f"{label}: train loss {leg['train_loss']} / val MAE "
          f"{leg['val_mae']} vs {what} {want['train_loss']} / "
          f"{want['val_mae']}: max rel {rel!r} (rtol {rtol}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the ranks leave {what}")
    return {"reference": what, "emulation": want,
            "max_rel_vs_emulation": rel}


def dp_steady_rate(n_train, seconds) -> float:
    """Train structures/s over epochs 2.. (the first captures)."""
    return n_train * (len(seconds) - 1) / sum(seconds[1:])


def data_parallel_phase(dev, work_dir, card):
    """The data_parallel phase (module docstring) -> (summary, counts)."""
    import numpy as np

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.cache import save_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.train.__main__ import main as train_main

    t_phase = time.perf_counter()
    counts, summary = {}, {"card": card}
    os.makedirs(work_dir, exist_ok=True)
    graphs = load_synthetic_mp(N_DP, DataConfig().featurize_config(),
                               seed=SEED)
    cache = os.path.join(work_dir, "dp_graphs.npz")
    save_graph_cache(graphs, cache)
    n_train = len(train_val_test_split(graphs, 0.8, 0.1, seed=SEED)[0])
    base = ["--cache", cache, "-b", str(BATCH), "--epochs", str(DP_EPOCHS),
            "--print-freq", "0", "--seed", str(SEED)]
    dp = ["--data-parallel", "--dist-backend", "gloo"]
    dense = ["--cgconv-impl", "pallas"]
    coo = ["--aggregation", COO_AGG]
    n_conv = ModelConfig().n_conv
    # the rates first, each run alone on the card: two ranks, then one
    # process of the same entry point on the same data and flags
    legs = {"dp_dense": DataParallelRun("dp_dense", work_dir,
                                        base + dp + dense).wait()}
    one = os.path.join(work_dir, "dp_one_process")
    rc, out = run_main(train_main, base + dense + [
        "--ckpt-dir", os.path.join(one, "ckpt"), "--out-dir",
        os.path.join(one, "out")], "dp_one_process")
    check(rc == 0, f"dp_one_process: the train entry point exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])
    # then COO and the NaN leg side by side, the emulations beside them
    runs = {"dp_coo": DataParallelRun("dp_coo", work_dir, base + dp + coo),
            "dp_guard": DataParallelRun(
                "dp_guard", work_dir, base + dp + dense,
                rank_env={1: {"CGNN_TPU_FAULTS": "nan_batch=1"}})}
    try:
        emulated = {label: dp_emulation(dev, graphs, kw) for label, kw in (
            ("dp_dense", {"dense_m": M, "cgconv_impl": "pallas"}),
            ("dp_coo", {"dense_m": 0, "aggregation": COO_AGG}))}
        legs.update({k: r.wait() for k, r in runs.items()})
    finally:
        for r in runs.values():
            r.kill()
    for label, traces in legs.items():
        per_step = (coo_per_step(n_conv) if label == "dp_coo"
                    else dense_per_step(n_conv))
        summary[label] = dp_hold(label, traces, per_step, counts)
        run_dir = os.path.join(work_dir, label)
        dp_committer(label, os.path.join(run_dir, "ckpt-rank0"),
                     [os.path.join(run_dir, f"{d}-rank{r}")
                      for r in range(1, DP_WORLD) for d in ("ckpt", "out")])
    g = summary["dp_guard"]
    check(sum(g["guard_skipped"]) >= 1
          and "FAULT INJECTION ACTIVE" in open(os.path.join(
              work_dir, "dp_guard", "rank1.log")).read(),
          f"dp_guard: skipped {g['guard_skipped']}")
    print(f"dp_guard: both ranks skipped {g['guard_skipped']} steps by "
          f"epoch, digests equal: ok")
    for label, want in emulated.items():
        summary[label].update(dp_against_emulation(label, summary[label],
                                                   want))
    two_s = np.max(summary["dp_dense"]["epoch_seconds_by_rank"],
                   axis=0).tolist()
    rates = {"two_ranks_one_card": dp_steady_rate(n_train, two_s),
             "one_process": dp_steady_rate(n_train, info["epoch_seconds"])}
    print(f"data_parallel rates on {card}: train structures/s over epochs "
          f"2-{DP_EPOCHS}, {DP_WORLD} ranks sharing the card "
          f"{rates['two_ranks_one_card']!r}, one process "
          f"{rates['one_process']!r} (one card: not a scaling figure)")
    summary["train_structures_per_s"] = rates
    # predict on process 0's checkpoint, against the plain path
    ck = os.path.join(work_dir, "dp_dense", "ckpt-rank0")
    pred_graphs = load_synthetic(N_PREDICT, DataConfig().featurize_config())
    want = plain_answers(dev, ck, "latest", pred_graphs)
    out_csv = os.path.join(work_dir, "dp_predict.csv")
    with PathRun("dp_predict") as run:
        rc, out = run_main(predict_main, [
            ck, "--synthetic", str(N_PREDICT), "-b", str(BATCH), "--wire",
            "featurized", "--out", out_csv], "dp_predict")
    check(rc == 0, f"dp_predict exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("predict: "))[9:])
    counts["dp_predict"] = predict_path(run, dense_per_step(n_conv), info)
    import csv as csvmod

    rows = list(csvmod.reader(open(out_csv)))
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    err = np.abs(got - want)
    ok = ([r[0] for r in rows] == [x.cif_id for x in pred_graphs]
          and got.shape == want.shape
          and bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want))))
    print(f"dp_predict: {N_PREDICT} structures on process 0's checkpoint "
          f"vs the plain path: max_abs_err {float(err.max())!r} (rtol "
          f"{SERVE_RTOL}, atol {SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "dp_predict: the CSV disagrees with the plain path")
    summary["dp_predict"] = {"max_abs_err_vs_plain": float(err.max()),
                             "structures_per_s": info["structures_per_s"]}
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"data_parallel: {summary['wall_s']!r} s")
    return summary, counts


GS_SHARDS = 2  # the graph_shards phase: G, ranks sharing the one card
GS_EPOCHS = 2  # gs_dense's epochs (gs_coo, gs_dp, dp_force: GS_SHORT)
GS_SHORT = 2
GS_RTOL = 1e-4  # a sharded leg vs one unsharded process (sums reordered)
N_DP_FORCE = 1024  # dp_force's synthetic LJ frames (FORCE_ATOMS atoms)
GS_EDGE_SHARE = 1.0 / GS_SHARDS + 0.05  # a rank's edge bytes over one's


def gs_one_process(label, argv) -> dict:
    """One unsharded process of the train entry point (in this process;
    not traced) -> its ``train:`` record."""
    from cgnn_tpu_torch.train.__main__ import main as train_main

    rc, out = run_main(train_main, argv, label)
    check(rc == 0, f"{label}: the train entry point exited {rc}")
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])


def gs_edge_bytes(label, leg, one) -> dict:
    """Each rank's staged edge bytes (its strip or chunk of the edge
    leaves, its mapping) against the unsharded process's, held to about
    1/G -> the record."""
    shares = [b / one["edge_bytes"] for b in leg["edge_bytes_by_rank"]]
    ok = all(0 < x <= GS_EDGE_SHARE for x in shares)
    print(f"{label}: edge bytes a rank {leg['edge_bytes_by_rank']} vs one "
          f"process {one['edge_bytes']}: shares {shares} (<= "
          f"{GS_EDGE_SHARE}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: a rank stages more than ~1/{GS_SHARDS} of the "
              f"edge bytes")
    return {"edge_bytes_by_rank": leg["edge_bytes_by_rank"],
            "edge_bytes_one_process": one["edge_bytes"],
            "edge_share_by_rank": shares}


def graph_shards_phase(dev, work_dir, card):
    """The graph_shards phase (module docstring) -> (summary, counts)."""
    import numpy as np

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.cache import load_graph_cache, save_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        load_synthetic_mp,
        load_synthetic_oc20,
        load_trajectory,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.trajectory import split_trajectory_groups
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.train.loop import batch_caps, sharded_caps

    t_phase = time.perf_counter()
    counts, summary = {}, {"card": card}
    os.makedirs(work_dir, exist_ok=True)
    fcfg = DataConfig().featurize_config()
    n_conv = ModelConfig().n_conv
    cache = os.path.join(work_dir, "dp_graphs.npz")
    if os.path.exists(cache):  # the data_parallel phase's
        graphs = load_graph_cache(cache)
    else:
        graphs = load_synthetic_mp(N_DP, fcfg, seed=SEED)
        save_graph_cache(graphs, cache)
    oc20 = load_synthetic_oc20(N_OC20, fcfg, seed=SEED)
    oc20_cache = os.path.join(work_dir, "gs_oc20.npz")
    save_graph_cache(oc20, oc20_cache)
    force_frames = load_trajectory(N_DP_FORCE, fcfg, seed=SEED,
                                   num_atoms=FORCE_ATOMS)
    mp_train = train_val_test_split(graphs, 0.8, 0.1, seed=SEED)[0]
    oc_train = train_val_test_split(oc20, 0.8, 0.1, seed=SEED)[0]
    f_train = split_trajectory_groups([force_frames], 0.8, 0.1,
                                      seed=SEED)[0]
    # the capacities the sharded runs round to, given to both sides so
    # the unsharded process packs the same batches
    nc, _ = sharded_caps(*batch_caps(mp_train, BATCH, M), M, GS_SHARDS)
    onc, oec = sharded_caps(*batch_caps(oc_train, OC20_BATCH, None), None,
                            GS_SHARDS)
    summary["caps"] = {"dense_node_cap": nc, "coo": [onc, oec]}
    common = ["--print-freq", "0", "--seed", str(SEED)]
    dense = ["--cache", cache, "-b", str(BATCH), "--node-cap", str(nc),
             *common]
    coo = ["--cache", oc20_cache, "-b", str(OC20_BATCH), "--aggregation",
           COO_AGG, "--node-cap", str(onc), "--edge-cap", str(oec),
           "--epochs", str(GS_SHORT), *common]
    force = ["--task", "force", "--synthetic", str(N_DP_FORCE),
             "--md-atoms", str(FORCE_ATOMS), "-b", str(BATCH), "--optim",
             "Adam", "--lr", "0.002", "--epochs", str(GS_SHORT), *common]
    shard = ["--graph-shards", str(GS_SHARDS), "--dist-backend", "gloo"]
    dp = ["--data-parallel", "--dist-backend", "gloo"]

    def one_dirs(label):
        d = os.path.join(work_dir, label)
        return ["--ckpt-dir", os.path.join(d, "ckpt"), "--out-dir",
                os.path.join(d, "out")]

    # the rates first, each run alone on the card: the sharded ranks, then
    # one unsharded process of the entry point on the same data and caps
    legs = {"gs_dense": DataParallelRun(
        "gs_dense", work_dir, dense + ["--epochs", str(GS_EPOCHS)] + shard,
        world=GS_SHARDS).wait()}
    ones = {"gs_dense": gs_one_process("gs_dense_one", dense + [
        "--epochs", str(GS_EPOCHS)] + one_dirs("gs_dense_one"))}
    legs["dp_force"] = DataParallelRun("dp_force", work_dir,
                                       force + dp).wait()
    ones["dp_force"] = gs_one_process("dp_force_one",
                                      force + one_dirs("dp_force_one"))
    # then the COO and D x G legs side by side, the references beside them
    runs = {"gs_coo": DataParallelRun("gs_coo", work_dir, coo + shard,
                                      world=GS_SHARDS),
            "gs_dp": DataParallelRun(
                "gs_dp", work_dir, dense + ["--epochs", str(GS_SHORT)]
                + shard + dp, world=2 * GS_SHARDS)}
    try:
        ones["gs_coo"] = gs_one_process("gs_coo_one",
                                        coo + one_dirs("gs_coo_one"))
        emulated = {
            "gs_dp": dp_emulation(dev, graphs, {"dense_m": M}, node_cap=nc,
                                  epochs=GS_SHORT),
            "dp_force": dp_emulation(dev, force_frames, {"dense_m": M},
                                     epochs=GS_SHORT, force=True)}
        legs.update({k: r.wait() for k, r in runs.items()})
    finally:
        for r in runs.values():
            r.kill()
    per_step = {"gs_dense": {}, "gs_dp": {}, "dp_force": {},
                "gs_coo": coo_per_step(n_conv)}
    epochs = {"gs_dense": GS_EPOCHS}
    for label, traces in legs.items():
        ep = epochs.get(label, GS_SHORT)
        summary[label] = dp_hold(label, traces, per_step[label], counts,
                                 epochs=ep, captured=label == "dp_force")
        run_dir = os.path.join(work_dir, label)
        dp_committer(label, os.path.join(run_dir, "ckpt-rank0"),
                     [os.path.join(run_dir, f"{d}-rank{r}")
                      for r in range(1, len(traces))
                      for d in ("ckpt", "out")], epochs=ep)
    for label in ("gs_dense", "gs_coo"):
        one = ones[label]
        summary[label].update(dp_against_emulation(
            label, summary[label], {"train_loss": one["train_loss"],
                                    "val_mae": one["val_metric"]},
            rtol=GS_RTOL, epochs=epochs.get(label, GS_SHORT),
            what="one unsharded process"))
        summary[label].update(gs_edge_bytes(label, summary[label], one))
    for label, want in emulated.items():
        summary[label].update(dp_against_emulation(
            label, summary[label], want, rtol=GS_RTOL, epochs=GS_SHORT))
    for r in range(2):
        check(counts[f"gs_coo.rank{r}"]["launches"]["segment_sum_sorted"]
              > 0, f"gs_coo rank {r}: kernel 6 never launched")
    n_train = {"gs_dense": len(mp_train), "gs_dp": len(mp_train),
               "gs_coo": len(oc_train), "dp_force": len(f_train)}
    rates = {}
    for label in legs:
        ranks = np.max(summary[label]["epoch_seconds_by_rank"],
                       axis=0).tolist()
        rates[label] = {"ranks": dp_steady_rate(n_train[label], ranks)}
        if label in ones:
            rates[label]["one_process"] = dp_steady_rate(
                n_train[label], ones[label]["epoch_seconds"])
    print(f"graph_shards rates on {card}: train structures/s (dp_force: "
          f"frames/s) over epochs 2.., the ranks sharing the card, and one "
          f"process; gs_dense and dp_force each ran alone, gs_coo and gs_dp "
          f"beside each other and the references (one card: not a "
          f"scaling figure): {json.dumps(rates, allow_nan=False)}")
    summary["structures_per_s"] = rates
    # predict on gs_dense's process-0 checkpoint, against the plain path
    ck = os.path.join(work_dir, "gs_dense", "ckpt-rank0")
    pred_graphs = load_synthetic(N_PREDICT, fcfg)
    want = plain_answers(dev, ck, "latest", pred_graphs)
    out_csv = os.path.join(work_dir, "gs_predict.csv")
    with PathRun("gs_predict") as run:
        rc, out = run_main(predict_main, [
            ck, "--synthetic", str(N_PREDICT), "-b", str(BATCH), "--wire",
            "featurized", "--out", out_csv], "gs_predict")
    check(rc == 0, f"gs_predict exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("predict: "))[9:])
    counts["gs_predict"] = predict_path(run, {}, info)
    import csv as csvmod

    rows = list(csvmod.reader(open(out_csv)))
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    err = np.abs(got - want)
    ok = ([r[0] for r in rows] == [x.cif_id for x in pred_graphs]
          and got.shape == want.shape
          and bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want))))
    print(f"gs_predict: {N_PREDICT} structures on gs_dense's process-0 "
          f"checkpoint vs the plain path: max_abs_err {float(err.max())!r} "
          f"(rtol {SERVE_RTOL}, atol {SERVE_ATOL}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "gs_predict: the CSV disagrees with the plain path")
    summary["gs_predict"] = {"max_abs_err_vs_plain": float(err.max()),
                             "structures_per_s": info["structures_per_s"]}
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"graph_shards: {summary['wall_s']!r} s")
    return summary, counts


DPD_EPOCHS = 3  # dpd_dense's epochs (its rate over epochs 2-3)
DPD_SHORT = 2  # the other dp_driver legs' epochs
DPD_PREEMPT_EPOCHS = 10  # the preempted ranks' run: long enough that the
# SIGTERM sent at process 0's first commit lands mid-run
DPD_PREEMPT_BATCH = 32  # many chunks an epoch: the signal lands between two


def dpd_driver_ran(label, traces) -> None:
    """Every rank of a leg trained under the epoch driver (its staging
    recorded, no fall-back) and drew the same chunks."""
    for r, t in enumerate(traces):
        staging = t["info"].get("staging", {})
        check("staged_bytes" in staging and "fallback" not in staging
              and t["driver_trace"],
              f"{label} rank {r}: the epoch driver did not run: {staging}")
        check(t["driver_trace"] == traces[0]["driver_trace"],
              f"{label}: rank {r} ran other chunks than rank 0")
    print(f"{label}: the epoch driver ran on every rank, "
          f"{sum(e != 'epoch' for e in traces[0]['driver_trace'])} chunks "
          f"each, the same on every rank: ok")


def dpd_preempt_argv(cache) -> list:
    return ["--cache", cache, "-b", str(DPD_PREEMPT_BATCH), "--epochs",
            str(DPD_PREEMPT_EPOCHS), "--print-freq", "0", "--seed",
            str(SEED), "--cgconv-impl", "pallas", "--device-resident",
            "--data-parallel", "--dist-backend", "gloo"]


def dpd_preempt_start(work_dir, cache):
    """Two ranks under the driver (the kernel path, batch
    ``DPD_PREEMPT_BATCH``) and a thread that SIGTERMs process 1 alone at
    process 0's first commit -> (the run, the thread)."""
    import glob
    import signal
    import threading

    run = DataParallelRun("dpd_preempt", work_dir, dpd_preempt_argv(cache))

    def at_first_commit():
        deadline = time.time() + DP_RANK_TIMEOUT_S
        while (not glob.glob(os.path.join(run.ckpt(0), "ckpt-*",
                                          "MANIFEST.json"))
               and all(p.poll() is None for p in run.procs)
               and time.time() < deadline):
            time.sleep(0.02)
        if run.procs[1].poll() is None:
            run.procs[1].send_signal(signal.SIGTERM)

    sender = threading.Thread(target=at_first_commit,
                              name="chip-smoke-dpd-sigterm", daemon=True)
    sender.start()
    return run, sender


def dpd_preempt_finish(work_dir, cache, run, sender) -> dict:
    """``dpd_preempt_start``'s ranks: both exit 75 after the same
    preemption line, the save under the epoch before the stopped one
    (mid-epoch; the same epoch at a boundary); then ``--resume auto``
    runs both to the last epoch, digests equal."""
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    try:
        traces = run.wait(expect=75)
    finally:
        run.kill()
        sender.join(timeout=60)
    lines = [[line for line in t["out"].splitlines()
              if line.startswith("preemption: ")] for t in traces]
    check(lines[0] and all(x == lines[0] for x in lines),
          f"dpd_preempt: the ranks stopped apart: {lines}")
    mid = "stopped at a chunk boundary" in lines[0][0]
    stopped = int(lines[0][0].split("epoch ")[1].split()[0])
    mgr = CheckpointManager(run.ckpt(0))
    try:
        saved = mgr.read_meta()["epoch"]
    finally:
        mgr.close()
    check(saved == (stopped - 1 if mid else stopped),
          f"dpd_preempt: stopped in epoch {stopped} ({lines[0][0]!r}) but "
          f"the save is under epoch {saved}")
    print(f"dpd_preempt: both ranks exited 75 after {lines[0][0]!r}; the "
          f"save under epoch {saved}: ok")
    resumed = DataParallelRun("dpd_preempt", work_dir,
                              dpd_preempt_argv(cache) + ["--resume", "auto"],
                              fresh=False).wait()
    infos = [t["info"] for t in resumed]
    digests = [i["dp"]["digests"] for i in infos]
    check(all(d == digests[0] for d in digests)
          and infos[0]["epochs"][0] == saved + 1
          and infos[0]["epochs"][-1] == DPD_PREEMPT_EPOCHS - 1,
          f"dpd_preempt resume: epochs {infos[0]['epochs']}, digests equal "
          f"{all(d == digests[0] for d in digests)}")
    print(f"dpd_preempt: resumed at epoch {saved + 1}, ran to "
          f"{DPD_PREEMPT_EPOCHS - 1}, digests equal on both ranks: ok")
    return {"preemption_line": lines[0][0], "mid_epoch": mid,
            "stopped_epoch": stopped, "saved_epoch": saved,
            "resumed_epochs": infos[0]["epochs"],
            "resume_wall_s": time.perf_counter() - t0}


def dp_driver_phase(dev, work_dir, card, per_step_rate):
    """The dp_driver phase (module docstring) -> (summary, counts).
    ``per_step_rate``: data_parallel's two ranks under the per-step loop
    (``dp_dense``, run alone in this call)."""
    import numpy as np

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.cache import load_graph_cache, save_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_mp,
        load_synthetic_oc20,
        load_trajectory,
        train_val_test_split,
    )
    from cgnn_tpu_torch.train.loop import batch_caps, sharded_caps

    t_phase = time.perf_counter()
    counts, summary = {}, {"card": card}
    os.makedirs(work_dir, exist_ok=True)
    fcfg = DataConfig().featurize_config()
    n_conv = ModelConfig().n_conv
    cache = os.path.join(work_dir, "dp_graphs.npz")
    oc20_cache = os.path.join(work_dir, "gs_oc20.npz")
    if os.path.exists(cache):  # the data_parallel phase's
        graphs = load_graph_cache(cache)
    else:
        graphs = load_synthetic_mp(N_DP, fcfg, seed=SEED)
        save_graph_cache(graphs, cache)
    if os.path.exists(oc20_cache):  # the graph_shards phase's
        oc20 = load_graph_cache(oc20_cache)
    else:
        oc20 = load_synthetic_oc20(N_OC20, fcfg, seed=SEED)
        save_graph_cache(oc20, oc20_cache)
    force_frames = load_trajectory(N_DP_FORCE, fcfg, seed=SEED,
                                   num_atoms=FORCE_ATOMS)
    mp_train = train_val_test_split(graphs, 0.8, 0.1, seed=SEED)[0]
    oc_train = train_val_test_split(oc20, 0.8, 0.1, seed=SEED)[0]
    nc, _ = sharded_caps(*batch_caps(mp_train, BATCH, M), M, GS_SHARDS)
    onc, oec = sharded_caps(*batch_caps(oc_train, OC20_BATCH, None), None,
                            GS_SHARDS)
    common = ["--print-freq", "0", "--seed", str(SEED), "--device-resident"]
    dense = ["--cache", cache, "-b", str(BATCH), *common]
    kernel = ["--cgconv-impl", "pallas", "--buckets", "3"]
    short = ["--epochs", str(DPD_SHORT)]
    coo = ["--cache", oc20_cache, "-b", str(OC20_BATCH), "--aggregation",
           COO_AGG, "--node-cap", str(onc), "--edge-cap", str(oec), *short,
           *common]
    force = ["--task", "force", "--synthetic", str(N_DP_FORCE), "--md-atoms",
             str(FORCE_ATOMS), "-b", str(BATCH), "--optim", "Adam", "--lr",
             "0.002", *short, *common]
    dp = ["--data-parallel", "--dist-backend", "gloo"]
    shard = ["--graph-shards", str(GS_SHARDS), "--dist-backend", "gloo"]
    # one process: the driver's compact staging off, as under the ranks
    one = ["--compact-staging", "off"]

    def one_dirs(label):
        d = os.path.join(work_dir, label)
        return ["--ckpt-dir", os.path.join(d, "ckpt"), "--out-dir",
                os.path.join(d, "out")]

    # the rates first, each run alone on the card: two ranks under the
    # driver, then one process under the driver on the same data and flags
    full = dense + ["--epochs", str(DPD_EPOCHS)] + kernel
    legs = {"dpd_dense": DataParallelRun("dpd_dense", work_dir,
                                         full + dp).wait()}
    ones = {"dpd_dense": gs_one_process("dpd_one", full + one
                                        + one_dirs("dpd_one"))}
    trace = {"dpd_dense": legs["dpd_dense"][0]["driver_trace"]}
    # then the rest side by side, two legs at a time, the emulations and
    # the unsharded references beside them
    gs_dense = dense + ["--node-cap", str(nc)] + short
    runs = {"dpd_coo": DataParallelRun(
                "dpd_coo", work_dir, dense + short + ["--aggregation",
                                                      COO_AGG] + dp),
            "gsd_dense": DataParallelRun("gsd_dense", work_dir,
                                         gs_dense + shard)}
    try:
        emulated = {"dpd_dense": dp_emulation(
            dev, graphs, {"dense_m": M, "cgconv_impl": "pallas"},
            epochs=DPD_EPOCHS, trace=trace["dpd_dense"], buckets=3)}
        ones["gsd_dense"] = gs_one_process(
            "gsd_dense_one", gs_dense + one + one_dirs("gsd_dense_one"))
        legs.update({k: r.wait() for k, r in runs.items()})
    finally:
        for r in runs.values():
            r.kill()
    runs = {"gsd_coo": DataParallelRun("gsd_coo", work_dir, coo + shard),
            "dpd_force": DataParallelRun("dpd_force", work_dir, force + dp)}
    preempt = dpd_preempt_start(work_dir, cache)
    try:
        emulated["dpd_coo"] = dp_emulation(
            dev, graphs, {"dense_m": 0, "aggregation": COO_AGG},
            epochs=DPD_SHORT, trace=legs["dpd_coo"][0]["driver_trace"])
        ones["gsd_coo"] = gs_one_process("gsd_coo_one",
                                         coo + one_dirs("gsd_coo_one"))
        legs.update({k: r.wait() for k, r in runs.items()})
        summary["dpd_preempt"] = dpd_preempt_finish(work_dir, cache,
                                                     *preempt)
    finally:
        for r in [*runs.values(), preempt[0]]:
            r.kill()
    emulated["dpd_force"] = dp_emulation(
        dev, force_frames, {"dense_m": M}, epochs=DPD_SHORT, force=True,
        trace=legs["dpd_force"][0]["driver_trace"])
    per_step = {"dpd_dense": dense_per_step(n_conv),
                "dpd_coo": coo_per_step(n_conv), "gsd_dense": {},
                "gsd_coo": coo_per_step(n_conv), "dpd_force": {}}
    for label, traces in legs.items():
        ep = DPD_EPOCHS if label == "dpd_dense" else DPD_SHORT
        summary[label] = dp_hold(label, traces, per_step[label], counts,
                                 epochs=ep,
                                 captured=not label.startswith("gsd"))
        dpd_driver_ran(label, traces)
        run_dir = os.path.join(work_dir, label)
        dp_committer(label, os.path.join(run_dir, "ckpt-rank0"),
                     [os.path.join(run_dir, f"{d}-rank{r}")
                      for r in range(1, len(traces))
                      for d in ("ckpt", "out")], epochs=ep)
    for label, want in emulated.items():
        ep = DPD_EPOCHS if label == "dpd_dense" else DPD_SHORT
        summary[label].update(dp_against_emulation(label, summary[label],
                                                   want, epochs=ep))
    for label in ("gsd_dense", "gsd_coo"):
        one_rec = ones[label]
        check("fallback" not in one_rec["staging"],
              f"{label}: the unsharded process fell back: "
              f"{one_rec['staging']}")
        summary[label].update(dp_against_emulation(
            label, summary[label], {"train_loss": one_rec["train_loss"],
                                    "val_mae": one_rec["val_metric"]},
            rtol=GS_RTOL, epochs=DPD_SHORT, what="one unsharded process"))
        summary[label].update(gs_edge_bytes(label, summary[label], one_rec))
    for label, kernels in (("dpd_dense", ("fused_cgconv_eval",
                                          "fused_cgconv_stats",
                                          "epilogue_reduce", "epilogue_dz")),
                           ("dpd_coo", ("segment_sum_sorted",)),
                           ("gsd_coo", ("segment_sum_sorted",))):
        for r in range(DP_WORLD):
            got = counts[f"{label}.rank{r}"]["launches"]
            check(all(got[k] > 0 for k in kernels),
                  f"{label} rank {r}: a kernel never launched: {got}")
    n_train = len(mp_train)
    two_s = np.max(summary["dpd_dense"]["epoch_seconds_by_rank"],
                   axis=0).tolist()
    rates = {"two_ranks_driver": dp_steady_rate(n_train, two_s),
             "two_ranks_per_step_loop": per_step_rate,
             "one_process_driver": dp_steady_rate(
                 n_train, ones["dpd_dense"]["epoch_seconds"])}
    print(f"dp_driver rates on {card}: train structures/s over epochs "
          f"2-{DPD_EPOCHS} on the 2048-structure cache, each run alone: two "
          f"ranks sharing the card under the driver "
          f"{rates['two_ranks_driver']!r} (--buckets 3), two ranks under the "
          f"per-step loop {rates['two_ranks_per_step_loop']!r} "
          f"(data_parallel's dp_dense, one bucket), one process under the "
          f"driver {rates['one_process_driver']!r} (one card: not a scaling "
          f"figure)")
    summary["train_structures_per_s"] = rates
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"dp_driver: {summary['wall_s']!r} s")
    return summary, counts


HTTP_CLIENTS = 16  # client threads of an HTTP burst
N_HTTP = 192  # requests of an HTTP burst (each wire)
N_HTTP_CACHE = 32  # requests repeated for the cache check
N_HTTP_DRAIN = 512  # the burst SIGTERM lands in
N_ITEM14 = 1024  # requests of an in-process burst (item 14's turns)
ITEM14_CLIENTS = 64
SERVE_BOOT_S = 300.0  # bound on a server's boot (imports, calibration, warm)
HTTP_P99_MS = 1000.0  # the JAX server's default per-request deadline
# the serve entry point run in a process under PathRun (traced_serve)
TRACED_SERVE = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.traced_serve(sys.argv[1], sys.argv[2:]))")


def traced_serve(out_path, argv) -> int:
    """``python -m cgnn_tpu_torch.serve ARGV`` in this process inside a
    ``PathRun`` (set up before the entry point starts, read after it
    exits), with the server's final ``stats()``, written to ``out_path``
    as JSON -> its exit code."""
    import cgnn_tpu_torch.serve.server as srv
    from cgnn_tpu_torch.serve.__main__ import main as serve_main

    servers = []
    load = srv.load_server

    def loading(*a, **kw):
        server, parts = load(*a, **kw)
        servers.append(server)
        return server, parts

    srv.load_server = loading
    with PathRun("serve") as run:
        rc = serve_main(argv)
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "launches": run.launches,
                   "wrapper": run.wrapper, "steps": run.steps,
                   "stats": servers[0].stats() if servers else None}, f,
                  allow_nan=False)
    return rc


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port, method, path, body=None, timeout=120.0):
    """One request on a new connection -> (status, JSON body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


class ServeProcess:
    """``python -m cgnn_tpu_torch.serve CKPT`` on a free port in a
    subprocess (through ``traced_serve`` when ``traced``), its output in
    ``<work_dir>/<label>.log``. ``stop`` (or the owner's ``finally``
    through ``kill``) ends it."""

    def __init__(self, label, ckpt, work_dir, args=(), faults="",
                 traced=True):
        self.label = label
        self.port = free_port()
        self.trace_path = os.path.join(work_dir, f"{label}.trace.json")
        self.log_path = os.path.join(work_dir, f"{label}.log")
        argv = [ckpt, "--port", str(self.port), *args]
        cmd = ([sys.executable, "-c", TRACED_SERVE, self.trace_path, *argv]
               if traced else
               [sys.executable, "-m", "cgnn_tpu_torch.serve", *argv])
        env = {k: v for k, v in os.environ.items() if k != "CGNN_TPU_FAULTS"}
        if faults:
            env["CGNN_TPU_FAULTS"] = faults
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=self._log, stderr=subprocess.STDOUT)

    def tail(self, n=3000) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def wait_ready(self) -> dict:
        """Poll ``/healthz`` until 200 -> its statuses in order (None:
        not listening yet) and the seconds from the start."""
        seen = []
        while time.perf_counter() - self.t0 < SERVE_BOOT_S:
            check(self.proc.poll() is None,
                  f"{self.label}: the server exited {self.proc.returncode} "
                  f"while booting:\n{self.tail()}")
            try:
                st, body = http_call(self.port, "GET", "/healthz", timeout=5)
            except OSError:
                st, body = None, None
            if not seen or seen[-1] != st:
                seen.append(st)
            if st == 200:
                return {"statuses": seen, "boot_s": time.perf_counter()
                        - self.t0, "healthz": body}
            time.sleep(0.02)
        raise SmokeFailure(f"{self.label}: not ready after {SERVE_BOOT_S} s "
                           f"({seen}):\n{self.tail()}")

    def stats(self) -> dict:
        st, body = http_call(self.port, "GET", "/stats")
        check(st == 200, f"{self.label}: /stats answered {st}")
        return body

    def wait(self, timeout=120.0) -> int:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure(f"{self.label}: still running after "
                               f"{timeout} s:\n{self.tail()}") from None

    def stop(self, timeout=120.0) -> int:
        """SIGTERM, then the exit code."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        return self.wait(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()

    def trace(self) -> dict:
        with open(self.trace_path) as f:
            return json.load(f)


def http_burst(port, bodies, clients=HTTP_CLIENTS, stop_on=None):
    """POST each body to ``/predict`` from ``clients`` threads, each on
    its own keep-alive connection -> (a result per body: status, answer,
    client start and end time; None for a body not sent), wall seconds.
    A client stops sending once it gets a status in ``stop_on``."""
    import http.client

    results = [None] * len(bodies)

    def client(k):
        conn = None
        for i in range(k, len(bodies), clients):
            t0 = time.perf_counter()
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                conn.request("POST", "/predict", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                status, body = r.status, json.loads(r.read())
            except (OSError, http.client.HTTPException, ValueError) as e:
                status, body = None, {"error": repr(e)}
                if conn is not None:
                    conn.close()
                conn = None
            results[i] = {"status": status, "body": body, "t0": t0,
                          "t1": time.perf_counter()}
            if stop_on and status in stop_on:
                break
        if conn is not None:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"chip-smoke-http-{k}")
               for k in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "an HTTP client hung")
    return results, time.perf_counter() - t0


def burst_rates(label, results, wall) -> dict:
    """requests/s and client-side latency quantiles of a burst, every
    answer a 200 with a finite prediction of one target, p99 in bound."""
    import numpy as np

    bad = [r for r in results if r is None or r["status"] != 200]
    check(not bad, f"{label}: {len(bad)} requests not answered 200: "
                   f"{bad[:2]}")
    preds = np.array([r["body"]["prediction"] for r in results], np.float64)
    check(preds.shape == (len(results), 1) and np.isfinite(preds).all(),
          f"{label}: predictions of shape {preds.shape}, finite "
          f"{bool(np.isfinite(preds).all())}")
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in results]
    p50, p99 = np.percentile(lat, [50, 99])
    rec = {"requests": len(results), "wall_s": wall,
           "requests_per_s": len(results) / wall,
           "latency_ms_p50": float(p50), "latency_ms_p99": float(p99),
           "server_latency_ms_p99": float(np.percentile(
               [r["body"]["latency_ms"] for r in results], 99))}
    print(f"{label}: {rec}")
    check(p99 <= HTTP_P99_MS, f"{label}: p99 {p99!r} ms > {HTTP_P99_MS} ms")
    return rec


def graph_body(g, **extra) -> bytes:
    payload = {"atom_fea": g.atom_fea.tolist(),
               "edge_fea": g.edge_fea.tolist(),
               "centers": g.centers.tolist(),
               "neighbors": g.neighbors.tolist(), "id": g.cif_id}
    return json.dumps({"graph": payload, **extra}, allow_nan=False).encode()


def structure_body(rs, **extra) -> bytes:
    return json.dumps({"structure": {
        "lattice": rs.lattice.tolist(),
        "frac_coords": rs.frac_coords.tolist(),
        "numbers": rs.numbers.tolist(), "id": rs.cif_id}, **extra},
        allow_nan=False).encode()


def plain_answers(dev, ck, name, graphs, dtype=None, tier=None):
    """The plain path (``cgconv_impl`` and ``fused_epilogue`` off;
    ``aggregation='xla'`` in the
    COO layout) under save ``name`` of checkpoint ``ck``, on the card, on
    ``graphs`` -> [n, T] (a classifier's [n, C]); ``dtype`` overrides the
    model's compute dtype (``'float32'``: the f32 model on the same
    weights), whose edge dtype the batches stage; ``tier``: the serving
    precision tier's model over it (serve/quantize.py)."""
    import dataclasses as dc

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.step import InferenceState

    mgr = CheckpointManager(ck)
    meta = mgr.read_meta(name)
    cfg = ModelConfig.from_meta(meta["model"]).for_arbitrary_inputs()
    cfg = dc.replace(cfg, cgconv_impl="", fused_epilogue="",
                     aggregation="xla" if not cfg.dense_m else None,
                     **({} if dtype is None else {"dtype": dtype}))
    state = InferenceState(
        build_model(cfg, DataConfig.from_meta(meta["data"]),
                    device=dev).eval(),
        Normalizer.identity(cfg.num_targets, device=dev))
    mgr.restore_for_inference(state, name)
    if tier is not None:
        from cgnn_tpu_torch.serve.quantize import TierSpec

        state = TierSpec(tier).state_for(state)
    ss = plan_shape_set(graphs, BATCH, rungs=2, dense_m=cfg.dense_m or None,
                        edge_dtype=cfg.torch_dtype)
    return run_fast_inference(state, graphs, BATCH, shape_set=ss)[0]


def hold_answers(label, results, want) -> float:
    """Every answer within SERVE_RTOL / SERVE_ATOL of its plain answer ->
    the largest difference."""
    import numpy as np

    got = np.array([r["body"]["prediction"] for r in results], np.float64)
    err = np.abs(got - want)
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"{label}: {len(results)} answers vs the plain path: max_abs_err "
          f"{float(err.max())!r} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: answers disagree with the plain path")
    return float(err.max())


def http_path(proc, rc, per_step) -> dict:
    """A traced server's run held to its flushes: each predict graph's
    warm-up replay (one a graph captured at ``warm()``) and each flush
    one run of its graph (raw flushes ``predict_raw`` steps); nothing
    failed, nothing captured after warm-up."""
    t = proc.trace()
    check(t["rc"] == rc == 0, f"{proc.label}: exit {rc}, traced {t['rc']}")
    st = t["stats"]
    c, by_form = st["counts"], st["captures_by_form"]
    check(c["captures_after_warm"] == 0 and c["batch_failures"] == 0,
          f"{proc.label}: {c}")
    warm_feat = by_form.get("full", 0) + by_form.get("compact", 0)
    run = types.SimpleNamespace(label=proc.label, launches=t["launches"],
                                wrapper=t["wrapper"], steps=t["steps"])
    return check_path(run, per_step, {
        "predict": warm_feat + c["batches"] - c["pack_raw"],
        "predict_raw": by_form.get("raw", 0) + c["pack_raw"]})


def commit_changed(ck) -> str:
    """Commit a new version of ``ck``'s newest save with changed weights
    (every parameter x1.25) and normalizer (mean + 1.5, std x1.5), the
    way a trainer commits one -> its name."""
    import numpy as np

    from cgnn_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_tree,
    )

    mgr = CheckpointManager(ck, keep=0)
    newest = mgr.newest_committed()
    tree = load_tree(os.path.join(ck, newest, STATE_FILE))

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return (t * np.float32(1.25)).astype(t.dtype)

    tree["params"] = scaled(tree["params"])
    norm = tree["normalizer"]
    tree["normalizer"] = {"mean": (norm["mean"] + 1.5).astype(np.float32),
                          "std": (norm["std"] * 1.5).astype(np.float32)}
    mgr.save_tree(tree, mgr.read_meta(newest))
    mgr.close()
    return CheckpointManager(ck).newest_committed()


def serve_http_phase(dev, work_dir, card):
    """The serve_http phase (module docstring) -> (summary, counts by
    path)."""
    import shutil
    import signal

    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_dataset
    from cgnn_tpu_torch.serve.server import structure_featurizer
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "serve_http")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ck, coo_ck = (os.path.join(root, d) for d in ("ckpt", "ckpt_coo"))
    base = ["--synthetic", str(N_TRAIN_SET), "-b", str(BATCH), "--epochs",
            "2", "--print-freq", "0", "--seed", str(SEED)]
    for d, flags in ((ck, ["--cgconv-impl", "pallas"]),
                     (coo_ck, ["--aggregation", COO_AGG])):
        rc, _ = run_main(train_main, base + flags + [
            "--ckpt-dir", d, "--out-dir", d + "_out"], "serve_http train")
        check(rc == 0, f"train entry point exited {rc}")
    v1 = CheckpointManager(ck).newest_committed()
    meta = CheckpointManager(ck).read_meta()
    data_cfg = DataConfig.from_meta(meta["data"])
    n_conv = meta["model"]["n_conv"]
    fcfg = data_cfg.featurize_config()
    featurize = structure_featurizer(data_cfg)
    per_step = dense_per_step(n_conv)

    def graphs(n, seed):
        return load_synthetic(n, fcfg, seed=seed)

    def structures(n, seed):
        return [RawStructure.from_structure(s, cif_id=sid)
                for sid, s, _ in synthetic_dataset(n, seed=seed)]

    summary = {"card": card, "checkpoint": v1}
    counts = {}
    procs = []

    def serve(label, ckpt=ck, args=(), faults="", traced=True):
        p = ServeProcess(label, ckpt, root, args, faults, traced)
        procs.append(p)
        return p

    try:
        # 2-4. boot and readiness; featurized graph JSON (full packs);
        # the cache; the classes; SIGTERM mid-burst -> drained, exit 0
        # servers boot side by side, all ready before a timed burst: the
        # two wire-form servers beside this one
        p = serve("serve_http", args=("--drain-linger", "2"))
        wire_servers = {path: serve(path, args=args) for path, args in (
            ("serve_http_raw", ()),
            ("serve_http_compact", ("--wire", "featurized")))}
        ready = p.wait_ready()
        for q in wire_servers.values():
            q.wait_ready()
        check(503 in ready["statuses"]
              and ready["statuses"][-1] == 200
              and ready["statuses"].index(503)
              < ready["statuses"].index(200),
              f"serve_http: /healthz went {ready['statuses']}, want 503 "
              f"(warming) then 200")
        print(f"serve_http: /healthz {ready['statuses']} in "
              f"{ready['boot_s']!r} s")
        g_full = graphs(N_HTTP, SEED + 21)
        res, wall = http_burst(p.port, [graph_body(g) for g in g_full])
        rec = {"featurized": burst_rates("serve_http featurized", res, wall)}
        check(all(r["body"]["wire"] == "featurized"
                  and not r["body"]["cached"] for r in res),
              "serve_http: a featurized answer came from the cache or the "
              "raw wire")
        rec["featurized"]["max_abs_err_vs_plain"] = hold_answers(
            "serve_http featurized", res,
            plain_answers(dev, ck, v1, g_full))
        first = res
        res, wall = http_burst(p.port, [graph_body(g) for g in
                                        g_full[:N_HTTP_CACHE]])
        hits = sum(r["body"]["cached"] for r in res)
        same = all(r["body"]["prediction"] == f["body"]["prediction"]
                   for r, f in zip(res, first))
        print(f"serve_http cache: {hits}/{N_HTTP_CACHE} repeats answered "
              f"cached, values equal to the misses' {same}")
        check(hits == N_HTTP_CACHE and same,
              "serve_http: repeats were not cache hits equal to the misses")
        rec["cache"] = {"repeats": N_HTTP_CACHE, "hits": hits}
        g_cls = graphs(N_HTTP, SEED + 22)
        classes = ("interactive", "batch", "scavenger")
        res, wall = http_burst(
            p.port, [graph_body(g, **{"class": classes[i % 3],
                                      "tenant": f"t{i % 2}"})
                     for i, g in enumerate(g_cls)], clients=32)
        rec["classes"] = burst_rates("serve_http classes", res, wall)
        pri = p.stats()["priority"]
        by_class = {c: sum(r["body"]["class"] == c for r in res)
                    for c in classes}
        print(f"serve_http classes: answered {by_class}; priority {pri}")
        check(all(by_class[c] == N_HTTP // 3 for c in classes)
              and pri["backfilled_total"] > 0,
              f"serve_http classes: answered {by_class}, backfilled "
              f"{pri['backfilled_total']}")
        rec["classes"].update(answered=by_class, priority=pri)
        hold_answers("serve_http classes", res,
                     plain_answers(dev, ck, v1, g_cls))
        # SIGTERM lands mid-burst: accepted requests answered, the rest
        # 503 (a client stops at its first 503), /healthz draining
        g_drain = graphs(N_HTTP_DRAIN, SEED + 23)
        bodies = [graph_body(g) for g in g_drain]
        out = {}

        def drain_burst():
            out["res"], out["wall"] = http_burst(p.port, bodies,
                                                 stop_on=(503,))

        th = threading.Thread(target=drain_burst, name="chip-smoke-drain")
        th.start()
        time.sleep(0.3)
        p.proc.send_signal(signal.SIGTERM)
        draining = None
        while draining is None and p.proc.poll() is None:
            try:
                st, body = http_call(p.port, "GET", "/healthz", timeout=5)
            except OSError:
                break
            if body.get("draining"):
                draining = (st, body)
            time.sleep(0.01)
        th.join(timeout=600)
        rc = p.wait()
        res = [r for r in out["res"] if r is not None]
        statuses = {s: sum(r["status"] == s for r in res)
                    for s in {r["status"] for r in res}}
        print(f"serve_http drain: exit {rc}; statuses {statuses}; "
              f"/healthz while draining {draining}")
        check(rc == 0 and set(statuses) <= {200, 503}
              and statuses.get(200, 0) > 0 and statuses.get(503, 0) > 0
              and draining is not None and draining[0] == 503,
              f"serve_http drain: exit {rc}, statuses {statuses}, /healthz "
              f"{draining}")
        ok = [r for r, g in zip(out["res"], g_drain)
              if r is not None and r["status"] == 200]
        hold_answers("serve_http drain", ok, plain_answers(
            dev, ck, v1, [g for r, g in zip(out["res"], g_drain)
                          if r is not None and r["status"] == 200]))
        rec["drain"] = {"exit": rc, "statuses": statuses}
        counts["serve_http"] = http_path(p, rc, per_step)
        rec["boot"] = ready
        summary["serve_http"] = rec

        # wire-form structures, each path its own process: staged raw
        # for the device search, and featurized on the packer thread
        # (``--wire featurized``), which stages them compactly
        for path, seed in (("serve_http_raw", SEED + 24),
                           ("serve_http_compact", SEED + 25)):
            p = wire_servers[path]
            xs = structures(N_HTTP, seed)
            res, wall = http_burst(p.port, [structure_body(x) for x in xs])
            rec = burst_rates(path, res, wall)
            rec["max_abs_err_vs_plain"] = hold_answers(
                path, res, plain_answers(dev, ck, v1,
                                         [featurize(x) for x in xs]))
            c = p.stats()["counts"]
            rec["wires"] = {w: sum(r["body"]["wire"] == w for r in res)
                            for w in ("raw", "featurized")}
            rec["packed"] = {k: c[k] for k in ("pack_raw", "pack_compact",
                                               "pack_full")}
            # a structure the device flags for cap overflow is answered
            # through the featurized wire, never from its truncated graph
            rec["ingest_cap_overflow"] = c["ingest_cap_overflow"]
            print(f"{path}: {rec['wires']}, {rec['packed']}, cap overflows "
                  f"{c['ingest_cap_overflow']}")
            check((c["pack_raw"] > 0 and rec["wires"]["raw"] > 0)
                  if path.endswith("raw") else c["pack_compact"] > 0,
                  f"{path}: flushes {rec['packed']}, wires {rec['wires']}")
            rc = p.stop()
            counts[path] = http_path(p, rc, per_step)
            summary[path] = rec

        # 5. a hot reload mid-burst: a second version committed while the
        # clients loop over the same requests (repeats hit the cache)
        p = serve("serve_http_reload", args=("--poll-interval", "0.5"))
        p.wait_ready()
        xs = graphs(N_HTTP // 2, SEED + 26)
        ss = structures(N_HTTP // 2, SEED + 27)
        bodies = [graph_body(x) for x in xs] + [structure_body(x)
                                                for x in ss]
        ref_graphs = xs + [featurize(x) for x in ss]
        passes, swap = [], {}
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                passes.append(http_burst(p.port, bodies)[0])

        th = threading.Thread(target=loop, name="chip-smoke-reload")
        th.start()
        while len(passes) < 1:
            time.sleep(0.01)
        v2 = commit_changed(ck)
        t_commit = time.perf_counter()
        while time.perf_counter() - t_commit < 60:
            st, body = http_call(p.port, "GET", "/healthz")
            if body["param_version"] == v2:
                swap["seen_at"] = time.perf_counter()
                break
            time.sleep(0.005)
        check("seen_at" in swap, f"serve_http_reload: {v2} never went live")
        n_seen = len(passes)
        while len(passes) < n_seen + 2:
            time.sleep(0.01)
        stop.set()
        th.join(timeout=600)
        stats = p.stats()
        rc = p.stop()
        want = {v1: plain_answers(dev, ck, v1, ref_graphs),
                v2: plain_answers(dev, ck, v2, ref_graphs)}
        results = [r for one in passes for r in one]
        check(all(r is not None and r["status"] == 200 for r in results),
              "serve_http_reload: a request was not answered 200")
        by_version = {v: 0 for v in want}
        stale, worst = [], 0.0
        for one in passes:
            for i, r in enumerate(one):
                b = r["body"]
                v = b["param_version"]
                check(v in want, f"serve_http_reload: answered by {v}")
                by_version[v] += 1
                err = abs(b["prediction"][0] - float(want[v][i, 0]))
                check(err <= SERVE_ATOL + SERVE_RTOL * abs(want[v][i, 0]),
                      f"serve_http_reload: request {i} answered by {v} "
                      f"differs from the plain path under {v} by {err!r}")
                worst = max(worst, err)
                if v == v1 and r["t0"] > swap["seen_at"]:
                    stale.append((i, b["cached"]))
        c = stats["counts"]
        print(f"serve_http_reload: {len(passes)} passes, answers by "
              f"version {by_version}, max_abs_err vs the plain path of "
              f"their version {worst!r}; old-version answers to requests "
              f"sent after the swap was seen {stale}; reloads "
              f"{c['reloads']}, captures after warm-up "
              f"{c['captures_after_warm']}")
        check(all(by_version.values()) and not stale and c["reloads"] == 1
              and c["captures_after_warm"] == 0 and rc == 0,
              "serve_http_reload: the reload broke its contract")
        counts["serve_http_reload"] = http_path(p, rc, per_step)
        summary["serve_http_reload"] = {
            "passes": len(passes), "answers_by_version": by_version,
            "max_abs_err_vs_plain_of_version": worst,
            "swap_seen_s_after_commit": swap["seen_at"] - t_commit,
            "cache": stats.get("cache"), "reload": stats.get("reload")}

        # 6. the fault hooks: a failed dispatch fails its flush alone;
        # an injected preemption exits 75; a wedged flush exits 3
        # the faults, wedge and COO servers boot side by side
        p = serve("serve_http_faults", faults="dispatch_exc=2;exit75_at=8",
                  traced=False)
        wedge = serve("serve_http_wedge", faults="wedge_flush=1:600",
                      args=("--drain-timeout", "3"), traced=False)
        coo = serve("serve_http_coo", ckpt=coo_ck)
        for q in (p, wedge, coo):
            q.wait_ready()
        seq = []
        for x in structures(16, SEED + 28):
            try:
                st, body = http_call(p.port, "POST", "/predict",
                                     structure_body(x))
            except OSError:
                break
            seq.append((st, body.get("reason")))
            if st not in (200, 500):
                break
        rc = p.wait()
        print(f"serve_http faults: statuses {seq}; exit {rc}")
        check(seq[:4] == [(200, None), (200, None),
                          (500, "dispatch_failed"), (200, None)]
              and rc == 75, f"serve_http faults: {seq}, exit {rc}")
        p = wedge
        xs = structures(2, SEED + 29)
        st0, _ = http_call(p.port, "POST", "/predict", structure_body(xs[0]))
        stuck = threading.Thread(
            target=lambda: http_burst(p.port, [structure_body(xs[1])], 1),
            name="chip-smoke-wedged", daemon=True)
        stuck.start()
        time.sleep(1.0)
        rc = p.stop(timeout=60)
        print(f"serve_http wedge: first answer {st0}, exit {rc}; "
              f"{p.tail(400)!r}")
        check(st0 == 200 and rc == 3 and "unanswered" in p.tail(),
              f"serve_http wedge: {st0}, exit {rc}")
        summary["faults"] = {"dispatch_exc_statuses": seq, "exit75": 75,
                             "wedge_exit": rc}

        # 7. COO weights through the entry point (kernel 6): featurized
        # graph JSON and structures featurized at admission
        p = coo
        xs = graphs(N_HTTP // 2, SEED + 30)
        ss = structures(N_HTTP // 2, SEED + 31)
        res, wall = http_burst(p.port, [graph_body(x) for x in xs]
                               + [structure_body(x) for x in ss])
        rec = burst_rates("serve_http_coo", res, wall)
        rec["max_abs_err_vs_plain"] = hold_answers(
            "serve_http_coo", res, plain_answers(
                dev, coo_ck, CheckpointManager(coo_ck).newest_committed(),
                xs + [featurize(x) for x in ss]))
        rc = p.stop()
        coo_meta = CheckpointManager(coo_ck).read_meta()
        counts["serve_http_coo"] = http_path(
            p, rc, coo_per_step(coo_meta["model"]["n_conv"]))
        summary["serve_http_coo"] = rec
    finally:
        for p in procs:
            p.kill()

    # 8. item 14: the serial worker against the pipelined one, in turns
    summary["item14"] = item14_turns(dev, ck, v1)
    summary["wall_s"] = time.perf_counter() - t_phase
    return summary, counts


def item14_turns(dev, ck, version):
    """In-process bursts that fill top-rung flushes: ``N_ITEM14``
    requests submitted at once from ``ITEM14_CLIENTS`` threads, through a
    serial worker (``pack_workers=0``, A) and a pipelined one (1, B) on
    the same checkpoint, in turns A B B A for each wire (featurized graphs
    packed full, compact, raw structures) -> requests/s, p99 (ms), the
    worker's wait on the pack stage and the share of its time it spent
    packing, each turn."""
    import dataclasses as dc

    import numpy as np

    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import raw_from_graph
    from cgnn_tpu_torch.serve.server import load_server

    calibration = load_synthetic_mp(64, seed=SEED, keep_geometry=True)
    servers = {}
    for name, workers in (("serial", 0), ("pipelined", 1)):
        servers[name], _ = load_server(
            ck, batch_size=64, rungs=3, calibration=calibration, device=dev,
            pack_workers=workers, cache_size=0, max_queue=N_ITEM14,
            default_timeout_ms=120_000.0, watch=False, wire="raw",
            compact="on", log_fn=lambda *a: None)
    ss = servers["serial"].shape_set
    raws = [r for r in map(raw_from_graph, calibration)
            if ss.admits_raw(r)]
    wires = {"featurized": [dc.replace(g, distances=None)
                            for g in calibration],
             "compact": calibration, "raw": raws}
    out = {}
    try:
        for wire, pool in wires.items():
            reqs = [pool[i % len(pool)] for i in range(N_ITEM14)]
            turns = []
            for name in ("serial", "pipelined", "pipelined", "serial"):
                turns.append(dict(item14_burst(servers[name], reqs),
                                  worker=name))
            out[wire] = turns
            print(f"item14 {wire}: " + "; ".join(
                f"{t['worker']} {t['requests_per_s']!r} req/s p99 "
                f"{t['latency_ms_p99']!r} ms pack share "
                f"{t['worker_pack_share']!r} wait "
                f"{t['pipeline_wait_s']!r} s" for t in turns))
        for name, server in servers.items():
            c = server.stats()["counts"]
            check(c["captures_after_warm"] == 0 and c["batch_failures"] == 0,
                  f"item14 {name} server: {c}")
    finally:
        for server in servers.values():
            check(server.drain(timeout_s=60), "an item-14 server did not "
                                              "drain")
    for wire, turns in out.items():
        a = [t["requests_per_s"] for t in turns if t["worker"] == "serial"]
        b = [t["requests_per_s"] for t in turns
             if t["worker"] == "pipelined"]
        out[wire] = {"turns": turns, "pipelined_over_serial":
                     float(np.mean(b) / np.mean(a))}
    return out


def item14_burst(server, reqs) -> dict:
    """``reqs`` submitted at once from ``ITEM14_CLIENTS`` threads (each
    submits its share, then waits for its answers) -> requests/s, p99 of
    the served latency, and the worker's timings over the burst."""
    import numpy as np

    before = server.stats()["ingest"]
    c0 = dict(server.counts)
    results = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            futs = [(i, server.submit(reqs[i]))
                    for i in range(k, len(reqs), ITEM14_CLIENTS)]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"chip-smoke-item14-{k}")
               for k in range(ITEM14_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and all(r is not None for r in results),
          f"item14: errors {errors[:2]}")
    after = server.stats()["ingest"]
    d = {k: after[k] - before[k] for k in ("worker_pack_s",
                                           "worker_dispatch_s",
                                           "pipeline_wait_s",
                                           "packers_pack_s")}
    flushes = server.counts["batches"] - c0["batches"]
    return {"requests_per_s": len(reqs) / wall, "wall_s": wall,
            "latency_ms_p99": float(np.percentile(
                [r.latency_ms for r in results], 99)),
            "flushes": flushes, "graphs_per_flush": len(reqs) / flushes,
            "worker_pack_share": d["worker_pack_s"] / wall, **d}


# ---------------------------------------------------------------------------
# heads and modes: bf16 compute, classification with dropout, multi-task
# ---------------------------------------------------------------------------

TIERS = ("f32", "bf16", "int8")
MAE_GATE = 1.005  # a tier's held-out MAE over f32's (scripts/quant_parity.py)
N_TIER_WIRE = 48  # wire-form MP-like structures of the tiers_serve_raw burst
N_DEV_PREDICT = 1024  # MP-like structures of the device-set bulk predicts
DEV_BATCHES = 16  # least batches a wire's bulk predict (8 an entry)
N_SWAP_CLIENTS = 8  # client threads of the hot swap under sharded dispatch


def weights_checkpoint(npz, meta_json, ck) -> str:
    """A checkpoint directory holding a parameter file's weights and
    normalizer (an inference-only save, as jax_checkpoint_to_torch.py
    writes one) -> its save's name."""
    import numpy as np

    from cgnn_tpu_torch.convert import load_params
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    variables, meta = load_params(npz, meta_json)
    norm = meta["normalizer"]
    tree = {"step": np.asarray(0, np.int64), "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "normalizer": {"mean": np.asarray(norm["mean"], np.float32),
                           "std": np.asarray(norm["std"], np.float32)}}
    mgr = CheckpointManager(ck, keep=0)
    try:
        mgr.save_tree(tree, {"model": meta["model"], "data": meta["data"],
                             "task": "regression", "epoch": 0}, is_best=True)
        mgr.wait()
        return mgr.newest_committed()
    finally:
        mgr.close()


def weights_state(dev, npz, meta_json, **cfg_over):
    """An InferenceState of a parameter file's weights, its model config
    overridden by ``cfg_over`` (the plain path's settings)."""
    import dataclasses as dc

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.convert import from_flax_variables, load_params
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.step import InferenceState

    variables, meta = load_params(npz, meta_json)
    cfg = dc.replace(ModelConfig.from_meta(meta["model"]), **cfg_over)
    model = build_model(cfg, DataConfig.from_meta(meta["data"]), device=dev)
    model.load_state_dict(from_flax_variables(variables))
    norm = meta["normalizer"]
    return InferenceState(model.eval(), Normalizer.from_arrays(
        norm["mean"], norm["std"], device=dev))


def hold_tier(label, got, want) -> float:
    """Every answer within BF16_TOL of the largest |answer| of its plain
    path -> the largest difference."""
    import numpy as np

    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = float(np.abs(want).max())
    ok = err <= BF16_TOL * scale
    print(f"{label}: {len(want)} answers vs the plain path: max_abs_err "
          f"{err!r} (BF16_TOL {BF16_TOL} of {scale!r}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: answers disagree with the plain path")
    return err


def mae_ratios(label, preds, targets) -> dict:
    """Each tier's MAE on the held-out split over f32's, at most
    MAE_GATE."""
    import numpy as np

    mae = {t: float(np.abs(np.asarray(p, np.float64) - targets).mean())
           for t, p in preds.items()}
    ratio = {t: mae[t] / mae["f32"] for t in mae if t != "f32"}
    ok = mae["f32"] > 0 and all(r <= MAE_GATE for r in ratio.values())
    print(f"{label}: held-out MAE {mae}, ratio to f32 {ratio} (gate "
          f"{MAE_GATE}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: a tier's MAE exceeds {MAE_GATE} of f32's")
    return {"mae": mae, "ratio_to_f32": ratio}


def swap_under_sharded_dispatch(dev, server, ck, graphs) -> dict:
    """Clients hammer the mesh ``server`` while a changed version is
    committed to ``ck`` and swapped in: every answer within SERVE_RTOL /
    SERVE_ATOL of the plain path under the version it reports, and no
    client gets the old version after it has seen the new one."""
    import numpy as np

    v1 = server.version
    results, lock, stop = [], threading.Lock(), threading.Event()
    errors = []

    def client(ci):
        rng = np.random.default_rng(ci)
        try:
            while not stop.is_set():
                k = int(rng.integers(len(graphs)))
                r = server.predict(graphs[k], timeout_ms=60_000)
                with lock:
                    results.append((ci, k, r))
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append(repr(e))

    def wait_for(n):
        end = time.perf_counter() + 120
        while time.perf_counter() < end:
            with lock:
                if len(results) >= n:
                    return
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"chip-smoke-swap-{i}")
               for i in range(N_SWAP_CLIENTS)]
    for th in threads:
        th.start()
    try:
        wait_for(64)
        v2 = commit_changed(ck)
        check(server.watcher.poll_once(), "the mesh server staged no swap")
        with lock:
            at_swap = len(results)
        wait_for(at_swap + 128)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
    check(not errors and not any(th.is_alive() for th in threads),
          f"swap clients: {errors[:2]}")
    refs = {v: plain_answers(dev, ck, v, graphs) for v in (v1, v2)}
    seen_new, worst, versions = set(), 0.0, set()
    for ci, k, r in results:
        versions.add(r.param_version)
        want = refs[r.param_version][k]
        err = float(np.abs(r.prediction - want).max())
        check(bool(np.all(np.abs(r.prediction - want)
                          <= SERVE_ATOL + SERVE_RTOL * np.abs(want))),
              f"swap: an answer labeled {r.param_version} (shard "
              f"{r.device_id}) is off its weights by {err!r}")
        worst = max(worst, err)
        if r.param_version == v2:
            seen_new.add(ci)
        else:
            check(ci not in seen_new, f"swap: client {ci} got {v1} after "
                                      f"{v2}")
    check(versions == {v1, v2}, f"swap: versions seen {versions}")
    rec = {"answers": len(results), "at_swap": at_swap, "versions": [v1, v2],
           "shards": sorted({r.device_id for _, _, r in results}),
           "max_abs_err_vs_plain": worst,
           "captures_after_warm":
               server.stats()["counts"]["captures_after_warm"]}
    check(rec["captures_after_warm"] == 0, f"swap: {rec}")
    print(f"devices swap: {json.dumps(rec, allow_nan=False)}: ok")
    return rec


def serve_devices_tiers_phase(dev, work_dir, card, split, calibration,
                              coo_weights):
    """The serve_devices_tiers phase (module docstring) -> (summary,
    counts by path)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import ModelConfig
    from cgnn_tpu_torch.data.cache import save_graph_cache
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import raw_from_graph
    from cgnn_tpu_torch.parallel.executor import MeshExecutor, batch_fields
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.serve.devices import resolve_devices
    from cgnn_tpu_torch.serve.quantize import TierSpec
    from cgnn_tpu_torch.serve.server import InferenceServer, load_server
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_for_inference,
    )
    from cgnn_tpu_torch.train.infer import (
        run_fast_inference,
        run_raw_inference,
    )

    root = os.path.join(work_dir, "devices_tiers")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    trained = os.path.join(work_dir, "trained")
    ck = os.path.join(root, "ckpt")
    v1 = weights_checkpoint(os.path.join(trained, "params.npz"),
                            os.path.join(trained, "meta.json"), ck)
    n_conv = ModelConfig.from_meta(CheckpointManager(ck).read_meta(v1)[
        "model"]).n_conv
    test_g = split[2]
    targets = np.stack([np.atleast_1d(g.target) for g in test_g]).astype(
        np.float64)
    n = len(test_g)
    quiet = lambda *a, **k: None  # noqa: E731
    kw = dict(batch_size=64, rungs=3, calibration=calibration, device=dev,
              default_timeout_ms=60_000.0, cache_size=0, wire="raw",
              log_fn=quiet, poll_interval_s=3600.0)
    summary = {"card": card, "checkpoint": v1}
    counts = {}
    # the HTTP server boots while the in-process legs run, its ladder
    # planned from the same MP-like calibration
    cal_cache = os.path.join(root, "calibration.npz")
    save_graph_cache(list(calibration), cal_cache)
    http = ServeProcess("tiers_http", ck, root,
                        ("--device", str(dev), "--precision",
                         "f32,bf16,int8", "--poll-interval", "0",
                         "--calibration-cache", cal_cache), traced=False)
    servers = []
    try:
        # ---- tiers, in process: dense, both wires ----
        t0 = time.perf_counter()
        server, _ = load_server(ck, precision="f32,bf16,int8", **kw)
        servers.append(server)
        boot = time.perf_counter() - t0
        st = server.stats()
        check(server.precisions == TIERS and server.engine == "single"
              and set(st["captures_by_tier"]) == set(TIERS),
              f"tiers server: {server.precisions}, {server.engine}, "
              f"{st['captures_by_tier']}")
        print(f"tiers: load_server + warm {boot!r} s, captures by tier "
              f"{st['captures_by_tier']}")
        lowp = ["bf16"] * n + ["int8"] * n
        rec = burst(server, test_g + test_g, "tiers_serve",
                    dense_per_step(n_conv, bf16=True), tiers=lowp)
        f32 = burst(server, test_g, tiers=["f32"] * n)
        check(rec["precisions"] == lowp and f32["precisions"] == ["f32"] * n,
              "tiers_serve: an answer reports another tier")
        preds = {"f32": f32["preds"], "bf16": rec["preds"][:n],
                 "int8": rec["preds"][n:]}
        plain = {t: plain_answers(dev, ck, v1, test_g, tier=t)
                 for t in TIERS}
        tiers = {"errors_vs_plain": {
            t: hold_tier(f"tiers_serve {t}", preds[t], plain[t])
            for t in TIERS}}
        tiers.update(mae_ratios("tiers_serve", preds, targets))
        wire_g = load_synthetic_mp(N_TIER_WIRE, seed=SEED + 41,
                                   keep_geometry=True)
        raws = [raw_from_graph(g) for g in wire_g]
        w = len(raws)
        rrec = burst(server, raws + raws, "tiers_serve_raw",
                     dense_per_step(n_conv, bf16=True),
                     tiers=["bf16"] * w + ["int8"] * w)
        check(rrec["raw_flushes"] > 0, "tiers_serve_raw ran no raw flush")
        for k, t in enumerate(("bf16", "int8")):
            tiers["errors_vs_plain"][f"raw_{t}"] = hold_tier(
                f"tiers_serve_raw {t}", rrec["preds"][k * w:(k + 1) * w],
                plain_answers(dev, ck, v1, wire_g, tier=t))
        # each tier alone, untraced, the same 2n requests
        tiers["requests_per_s"] = {
            t: burst(server, test_g + test_g, tiers=[t] * (2 * n))[
                "requests_per_s"] for t in TIERS}
        tiers["requests_per_s"].update(
            raw_bf16_int8_traced=rrec["requests_per_s"])
        counts["tiers_serve"] = rec.pop("path")
        counts["tiers_serve_raw"] = rrec.pop("path")
        tiers["raw_flushes"] = rrec["raw_flushes"]

        # ---- tiers, COO ----
        cnpz, cmeta, _, ccfg = coo_weights
        cserver, _ = load_server(cnpz, cmeta, batch_size=64, rungs=3,
                                 calibration=calibration, device=dev,
                                 default_timeout_ms=60_000.0, cache_size=0,
                                 wire="featurized", log_fn=quiet,
                                 precision="f32,bf16,int8")
        servers.append(cserver)
        crec = burst(cserver, test_g + test_g, "tiers_serve_coo",
                     coo_per_step(ccfg.n_conv, bf16=True), tiers=lowp)
        cplain = weights_state(dev, cnpz, cmeta, aggregation="xla")
        css = plan_shape_set(test_g, BATCH, rungs=2, dense_m=None)
        for k, t in enumerate(("bf16", "int8")):
            want = run_fast_inference(TierSpec(t).state_for(cplain),
                                      test_g, BATCH, shape_set=css)[0]
            tiers["errors_vs_plain"][f"coo_{t}"] = hold_tier(
                f"tiers_serve_coo {t}", crec["preds"][k * n:(k + 1) * n],
                want)
        tiers["requests_per_s"]["coo_bf16_int8_traced"] = \
            crec["requests_per_s"]
        counts["tiers_serve_coo"] = crec.pop("path")
        check(cserver.drain(timeout_s=60), "the COO tiers server did not "
                                           "drain")
        servers.remove(cserver)

        # ---- tiers over HTTP, the entry point ----
        ready = http.wait_ready()
        bodies, want_tier = [], []
        for t in TIERS:
            bodies += [graph_body(g, precision=t) for g in test_g]
            want_tier += [t] * n
        res, wall = http_burst(http.port, bodies)
        hrec = burst_rates("tiers_http", res, wall)
        check([r["body"]["precision"] for r in res] == want_tier,
              "tiers_http: an answer reports another tier")
        hpreds = {t: np.array([r["body"]["prediction"]
                               for r in res[k * n:(k + 1) * n]])
                  for k, t in enumerate(TIERS)}
        hrec["errors_vs_plain"] = {
            t: hold_tier(f"tiers_http {t}", hpreds[t], plain[t])
            for t in TIERS}
        hrec.update(mae_ratios("tiers_http", hpreds, targets))
        g_new = load_synthetic_mp(1, seed=SEED + 43)[0]
        seq = [(t, http_call(http.port, "POST", "/predict",
                             graph_body(g_new, precision=t))[1])
               for t in ("f32", "f32", "int8", "int8")]
        ok = (not seq[0][1]["cached"] and seq[1][1]["cached"]
              and not seq[2][1]["cached"] and seq[3][1]["cached"]
              and seq[2][1]["precision"] == seq[3][1]["precision"] == "int8"
              and seq[2][1]["prediction"] != seq[0][1]["prediction"]
              and seq[3][1]["prediction"] == seq[2][1]["prediction"])
        print(f"tiers_http cache: {[(t, b['cached'], b['precision']) for t, b in seq]}: "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "tiers_http: the cache mixed tiers")
        hst = http.stats()
        check(hst["counts"]["captures_after_warm"] == 0
              and hst["counts"]["batch_failures"] == 0
              and hst["precisions"] == list(TIERS),
              f"tiers_http stats: {hst['counts']}")
        hrec.update(boot_s=ready["boot_s"],
                    responses_by_tier={t: hst["counts"].get(
                        f"responses_{t}", 0) for t in ("bf16", "int8")})
        check(http.stop() == 0, "tiers_http: exit code")
        tiers["http"] = hrec
        summary["tiers"] = tiers

        # ---- devices on the one card ----
        devs = {}
        err = io.StringIO()
        too_many = (torch.cuda.device_count() if dev.type == "cuda"
                    else 1) + 1
        with contextlib.redirect_stderr(err):
            rc = predict_main([ck, "--device", str(dev), "--devices",
                               str(too_many), "--synthetic", "4", "--out",
                               os.path.join(root, "x.csv")])
        check(rc == 2 and "local device(s) exist" in err.getvalue(),
              f"predict --devices {too_many}: exit {rc}, {err.getvalue()!r}")
        devs["predict_devices_beyond"] = {"devices": too_many, "exit": rc,
                                          "message": err.getvalue().strip()}
        auto = InferenceServer(server.state, server.shape_set, device=dev,
                               devices=resolve_devices("auto", dev),
                               engine="mesh", log_fn=quiet)
        check(auto.engine == "single", f"mesh on auto reads {auto.engine}")
        devs["mesh_on_auto"] = auto.engine
        del auto
        pair = [dev, dev]
        ss = server.shape_set
        ex = MeshExecutor(pair)
        parts = [ss.pack_full(test_g[k:k + 4], shape=ss.largest)
                 for k in (0, 4)]
        staged = ex.stage(ex.stack(parts))
        torch.cuda.synchronize()
        one = sum(t.numel() * t.element_size()
                  for t in batch_fields(parts[0]).values())
        check(ex.staged_bytes == [one, one]
              and all(torch.equal(batch_fields(s)[k].cpu(), t)
                      for s, p in zip(staged, parts)
                      for k, t in batch_fields(p).items())
              and all(t.device == dev for s in staged
                      for t in batch_fields(s).values()),
              f"stage: {ex.staged_bytes}, want {one} an entry")
        devs["stage_bytes_each"] = one
        # bulk predict, both wires, both engines, at DEV_BATCHES batches
        # or more a wire: every entry meets the top rung often enough to
        # capture it and replay (a shape's third batch captures)
        state, _, _ = load_for_inference(ck, v1, dev)
        pg = load_synthetic_mp(N_DEV_PREDICT, seed=SEED + 42,
                               keep_geometry=True)
        praws = [r for r in map(raw_from_graph, pg) if ss.admits_raw(r)]
        need = DEV_BATCHES * ss.largest.graph_cap
        praws = (praws * -(-need // len(praws)))[:max(need, len(praws))]

        def bulk(wire, stats=None, **kw_):
            if wire:
                return run_raw_inference(state, praws, ss, stats=stats,
                                         **kw_)
            return run_fast_inference(state, pg, 64, shape_set=ss,
                                      stats=stats, **kw_)

        # structures/s end to end, from a second, untraced call of the
        # same inputs (each call opens its own entries and captures its
        # own graphs: capture included)
        rates, want = {}, {}
        for wire in ("", "raw_"):
            st_ = {}
            want[wire] = bulk(wire, st_)[0]
            check(st_["batches"] >= DEV_BATCHES
                  and st_["entry_replays"][0] > 0,
                  f"one entry, {wire or 'featurized'}: {st_}")
            rates[f"devices_predict_{wire}single"] = {
                "structures_per_s": bulk(wire)[1],
                "batches": st_["batches"], "graph_replays":
                    st_["graph_replays"]}
        for engine in ("mesh", "threads"):
            shards = 2 if engine == "mesh" else 1
            for wire in ("", "raw_"):
                label = f"devices_predict_{wire}{engine}"
                st_ = {}
                with PathRun(label) as run:
                    got = bulk(wire, st_, devices=pair, engine=engine)[0]
                check(np.array_equal(got, want[wire]),
                      f"{label}: answers differ from one entry's, max "
                      f"{float(np.abs(got - want[wire]).max())!r}")
                check(st_["batches"] >= DEV_BATCHES
                      and all(r > 0 for r in st_["entry_replays"]),
                      f"{label}: an entry replayed no graph: {st_}")
                kind = "predict_raw" if wire else "predict"
                counts[label] = check_path(run, dense_per_step(n_conv), {
                    kind: st_["dispatches"] * shards})
                rates[label] = {
                    "structures_per_s": bulk(wire, devices=pair,
                                             engine=engine)[1],
                    "batches": st_["batches"],
                    "dispatches": st_["dispatches"],
                    "entry_replays": st_["entry_replays"],
                    "staged_bytes": st_.get("staged_bytes")}
                if engine == "mesh":
                    sb = st_["staged_bytes"]
                    check(sb[0] == sb[1] > 0, f"{label}: staged {sb}")
        devs["bulk_predict"] = rates
        # servers over the pair, one request a flush against one entry
        for engine in ("mesh", "threads"):
            eck = ck
            if engine == "mesh":  # the swap leg commits to its own copy
                eck = os.path.join(root, "ckpt_mesh")
                shutil.copytree(ck, eck)
            srv, _ = load_server(eck, devices=pair, engine=engine, **kw)
            servers.append(srv)
            check(srv.engine == engine, f"{engine}: reads {srv.engine}")
            for g in test_g[:16]:
                a = srv.predict(g, timeout_ms=60_000)
                b = server.predict(g, timeout_ms=60_000)
                check(np.array_equal(a.prediction, b.prediction),
                      f"devices_serve_{engine}: one request a flush differs "
                      f"from one entry's by "
                      f"{float(np.abs(a.prediction - b.prediction).max())!r}")
            label = f"devices_serve_{engine}"
            drec = burst(srv, test_g + test_g, label, dense_per_step(n_conv),
                         runs_a_flush=2 if engine == "mesh" else 1)
            want = np.concatenate([preds["f32"]] * 2)
            close = bool(np.all(np.abs(drec["preds"] - want)
                                <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
            sst = srv.stats()
            dispatches = [d["dispatches"] for d in sst["devices"]]
            # every entry dispatches (under threads the router's
            # round-robin ties spread even one request a flush); a mesh
            # flush of several requests answers from both shards
            check(close and all(x >= 1 for x in dispatches)
                  and (engine == "threads"
                       or set(drec["device_ids"]) == {0, 1}),
                  f"{label}: close {close}, dispatches {dispatches}, "
                  f"shards {set(drec['device_ids'])}")
            counts[label] = drec.pop("path")
            # the rate untraced, the same 2n f32 requests as the one-entry
            # server's tiers["requests_per_s"]["f32"]
            entry = {"requests_per_s": burst(srv, test_g + test_g)[
                         "requests_per_s"],
                     "dispatches": dispatches,
                     "flushes": drec["flushes"]}
            if engine == "mesh":
                sb = sst["staged_bytes"]
                check(sb[0] == sb[1] > 0, f"{label}: staged {sb}")
                entry["staged_bytes"] = sb
                entry["swap"] = swap_under_sharded_dispatch(dev, srv, eck,
                                                            test_g)
            devs[label] = entry
            check(srv.drain(timeout_s=60), f"{label}: did not drain")
            servers.remove(srv)
        summary["devices"] = devs
    finally:
        for srv in servers:
            srv.drain(timeout_s=60)
        http.kill()
    return summary, counts


def tiers_raw_late_phase(dev, work_dir, calibration):
    """ROADMAP Queue 3, item 13's probe: ``serve_devices_tiers``'s
    ``tiers_serve_raw`` burst again, on a fresh tiers server over the
    phase's checkpoint, late in the process (after every other phase),
    as ``tiers_serve_raw_late``. The answers are held to the plain path
    and the step and wrapper counts to the flushes as in the early
    burst; the card's count from the trace is recorded, exact or not
    (``check_path(card_exact=False)``: each kernel must still launch on
    the card), since a trace short of a record late in a long process is
    the open question this leg reads. -> (record, counts by path)."""
    from cgnn_tpu_torch.config import ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import raw_from_graph
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    ck = os.path.join(work_dir, "devices_tiers", "ckpt")
    v1 = CheckpointManager(ck).newest_committed()
    n_conv = ModelConfig.from_meta(CheckpointManager(ck).read_meta(v1)[
        "model"]).n_conv
    server, _ = load_server(ck, precision="f32,bf16,int8", batch_size=64,
                            rungs=3, calibration=calibration, device=dev,
                            default_timeout_ms=60_000.0, cache_size=0,
                            wire="raw", log_fn=lambda *a, **k: None,
                            poll_interval_s=3600.0)
    try:
        wire_g = load_synthetic_mp(N_TIER_WIRE, seed=SEED + 41,
                                   keep_geometry=True)
        raws = [raw_from_graph(g) for g in wire_g]
        w = len(raws)
        rec = burst(server, raws + raws, "tiers_serve_raw_late",
                    dense_per_step(n_conv, bf16=True),
                    tiers=["bf16"] * w + ["int8"] * w, card_exact=False)
        check(rec["raw_flushes"] > 0, "tiers_serve_raw_late ran no raw "
                                      "flush")
        errs = {t: hold_tier(f"tiers_serve_raw_late {t}",
                             rec["preds"][k * w:(k + 1) * w],
                             plain_answers(dev, ck, v1, wire_g, tier=t))
                for k, t in enumerate(("bf16", "int8"))}
    finally:
        check(server.drain(timeout_s=60), "the late tiers server did not "
                                          "drain")
    path = rec.pop("path")
    out = {"card_exact": path["card_exact"], "flushes": rec["flushes"],
           "raw_flushes": rec["raw_flushes"], "errors_vs_plain": errs,
           "launches": path["launches"], "card_want": path["card_want"]}
    print(f"tiers_serve_raw_late: card count exact: {path['card_exact']}")
    return out, {"tiers_serve_raw_late": path}


N_HM = 640  # MP-like CIFs of the heads_modes phase (512/64/64)
HM_EPOCHS = 2
HM_TASKS = ("formation_energy", "band_gap", "bulk_modulus", "shear_modulus")
HM_EMPTY = 0.25  # share of the multi-task label cells left empty
N_HM_SERVE = 96  # featurized requests of each heads_modes burst
N_HM_RAW = 32  # wire-form requests of the bf16 raw burst


def bf16_kernel_phase(dev, train_graphs, calibration, shape_set):
    """The bf16 instances of kernels 1, 2, 4 and 5 at the training shape
    (a snug batch-256 pack of MP-like structures, its nodes and edges
    rounded to bf16; z for kernels 4 and 5 rematerialized in bf16 as the
    training backward does), kernel 1 also at the top serving rung: each
    against its plain version (the f32 plain version on the widened
    inputs; kernel 5's dz in bf16, within one bf16 ulp), each also
    bit-equal to its f32 instance on the widened inputs, timed beside its
    bound with 2-byte nodes, edges and z -> their entries."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    bf16 = torch.bfloat16
    node_cap, edge_cap = capacities_for(train_graphs, BATCH, dense_m=M)
    batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                     edge_cap, dense_m=M, in_cap=0,
                                     snug=True)))
    n, m, g = batch.edges.shape
    f = 64
    real_slots, _ = slot_counts(batch)
    touched = fc.touched_nodes(batch.neighbors, batch.edge_mask, n)

    def bf16_args(b):
        a = list(conv_inputs(dev, b))
        a[0], a[1] = a[0].to(bf16), a[1].to(bf16)
        return a

    def wide(a):
        return [a[0].float(), a[1].float(), *a[2:]]

    entries = []
    # 1-bf16: the training shape, then the top serving rung
    cargs = bf16_args(batch)
    got = fc.fused_cgconv_eval_bf16_cuda(*cargs)
    check(torch.equal(got, fc.fused_cgconv_eval_cuda(*wide(cargs))),
          "kernel 1-bf16 differs from kernel 1 on the widened inputs")
    errs = compare("fused_cgconv_eval_bf16", got,
                   fc.fused_cgconv_eval_reference(*cargs), RTOL, ATOL)
    entry = kernel_entry(
        "fused_cgconv_eval_bf16", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:305", errs,
        timings(cold(fc.fused_cgconv_eval_bf16_cuda, *cargs)),
        time_ms(cold(fc.fused_cgconv_eval_reference, *cargs)),
        fc.eval_pass_cost(n, m, g, f, real_slots, touched, storage_bytes=2))
    entry["device_ms_by_launch"] = by_launch(
        cold(fc.fused_cgconv_eval_bf16_cuda, *cargs), K1_PARTS)
    top = shape_set.pack_full(calibration, shape=shape_set.largest)
    targs = bf16_args(top)
    tn = top.edges.shape[0]
    t_real, _ = slot_counts(top)
    t_errs = compare("fused_cgconv_eval_bf16 at the top serving rung",
                     fc.fused_cgconv_eval_bf16_cuda(*targs),
                     fc.fused_cgconv_eval_reference(*targs), RTOL, ATOL)
    t_bound, t_by = bound(fc.eval_pass_cost(
        tn, m, g, f, t_real, fc.touched_nodes(top.neighbors, top.edge_mask,
                                              tn), storage_bytes=2))
    entry["top_serving_rung"] = {
        "N": tn, "max_abs_err": t_errs[0], "max_rel_err": t_errs[1],
        **timings(cold(fc.fused_cgconv_eval_bf16_cuda, *targs)),
        "plain_ms": time_ms(cold(fc.fused_cgconv_eval_reference, *targs)),
        "bound_ms": t_bound, "bound_by": t_by,
        "device_ms_by_launch": by_launch(
            cold(fc.fused_cgconv_eval_bf16_cuda, *targs), K1_PARTS)}
    print(f"fused_cgconv_eval_bf16 at the top serving rung (N={tn}): "
          f"{entry['top_serving_rung']}")
    entries.append(entry)

    # 2-bf16: alone, again, on a shared node pass, and against kernel 2
    nodes, edges, kernel, bias, scale, bn_bias, nbr, emask = cargs[:8]
    shift = fc._shift_row0(nodes, edges, kernel, bias, nbr, bf16)
    sargs = (nodes, edges, kernel, bias, nbr, emask, shift)
    got = fc.fused_cgconv_stats_bf16_cuda(*sargs)
    again = fc.fused_cgconv_stats_bf16_cuda(*sargs)
    shared = fc.fused_cgconv_stats_bf16_cuda(
        *sargs, p=fc.fused_cgconv_node_bf16_cuda(nodes, kernel, bias))
    f32 = fc.fused_cgconv_stats_cuda(nodes.float(), edges.float(),
                                     *sargs[2:])
    torch.cuda.synchronize()
    check(torch.equal(got, again) and torch.equal(got, shared)
          and torch.equal(got, f32),
          "kernel 2-bf16: not the same bits run to run, on a shared node "
          "pass, or as kernel 2 on the widened inputs")
    errs = compare("fused_cgconv_stats_bf16", got,
                   fc.fused_cgconv_stats_reference(*sargs), STATS_RTOL,
                   row_scale=True)
    entry = kernel_entry(
        "fused_cgconv_stats_bf16", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:277", errs,
        timings(cold(fc.fused_cgconv_stats_bf16_cuda, *sargs)),
        time_ms(cold(fc.fused_cgconv_stats_reference, *sargs)),
        fc.stats_pass_cost(n, m, g, f, real_slots, touched,
                           storage_bytes=2))
    entry["device_ms_by_launch"] = by_launch(
        cold(fc.fused_cgconv_stats_bf16_cuda, *sargs), K2_PARTS)
    entries.append(entry)

    # 4-bf16 and 5-bf16 on z rematerialized in bf16
    z = fc._z_structured(nodes, edges, kernel, bias, nbr, bf16).contiguous()
    mean, var, n_real = fe.masked_stats(z, emask)
    cst = fe.pack_cst(mean, torch.rsqrt(var + 1e-5), scale, bn_bias)
    ct = torch.randn(n, f, device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    got = fe.epilogue_reduce_bf16_cuda(z, emask, cst, ct)
    again = fe.epilogue_reduce_bf16_cuda(z, emask, cst, ct)
    torch.cuda.synchronize()
    check(torch.equal(got, again)
          and torch.equal(got, fe.epilogue_reduce_cuda(z.float(), emask,
                                                       cst, ct)),
          "kernel 4-bf16: not the same bits run to run or as kernel 4 on "
          "the widened z")
    red = fe.epilogue_reduce_reference(z, emask, cst, ct)
    errs = compare("epilogue_reduce_bf16", got, red, REDUCE_RTOL,
                   row_scale=True)
    entry = kernel_entry(
        "epilogue_reduce_bf16", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:152", errs,
        timings(cold(fe.epilogue_reduce_bf16_cuda, z, emask, cst, ct)),
        time_ms(cold(fe.epilogue_reduce_reference, z, emask, cst, ct)),
        fe.epilogue_pass_cost("reduce", n, m, f, real_slots, z_bytes=2))
    entry["device_ms_by_launch"] = by_launch(
        cold(fe.epilogue_reduce_bf16_cuda, z, emask, cst, ct), K4_PARTS)
    entries.append(entry)

    inv_c = torch.full((1, 2 * f), 1.0 / max(float(n_real), 1.0),
                       device=dev)
    red5 = torch.cat([red, inv_c]).contiguous()
    got = fe.epilogue_dz_bf16_cuda(z, emask, cst, red5, ct)
    check(got.dtype == bf16 and torch.equal(
        got, fe.epilogue_dz_cuda(z.float(), emask, cst, red5, ct).to(bf16)),
        "kernel 5-bf16 is not kernel 5's dz on the widened z, rounded")
    errs = compare("epilogue_dz_bf16 (one bf16 ulp)", got.float(),
                   fe.epilogue_dz_reference(z, emask, cst, red5,
                                            ct).float(), BF16_ULP, ATOL)
    entries.append(kernel_entry(
        "epilogue_dz_bf16", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:175", errs,
        timings(cold(fe.epilogue_dz_bf16_cuda, z, emask, cst, red5, ct)),
        time_ms(cold(fe.epilogue_dz_reference, z, emask, cst, red5, ct)),
        fe.epilogue_pass_cost("dz", n, m, f, real_slots, z_bytes=2)))

    # 3-bf16 on the same bf16 z: an f32 sum, as kernel 3's
    got = fe.epilogue_apply_bf16_cuda(z, emask, cst)
    check(got.dtype == torch.float32 and torch.equal(
        got, fe.epilogue_apply_cuda(z.float(), emask, cst)),
        "kernel 3-bf16 is not kernel 3 on the widened z")
    errs = compare("epilogue_apply_bf16", got,
                   fe.epilogue_apply_reference(z, emask, cst), RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_apply_bf16", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:142", errs,
        timings(cold(fe.epilogue_apply_bf16_cuda, z, emask, cst)),
        time_ms(cold(fe.epilogue_apply_reference, z, emask, cst)),
        fe.epilogue_pass_cost("apply", n, m, f, real_slots, z_bytes=2)))
    entries.append(segment_sum_bf16_entry(dev, train_graphs))
    for e in entries:
        e.update(row=BF16_ROWS[e["name"]], dtype="bf16")
        e.setdefault("N", n)
    return entries


def segment_sum_bf16_entry(dev, train_graphs):
    """Kernel 6's bf16 instance at the COO training shape (a snug batch-256
    COO pack of MP-like structures): seeded [E, 64] messages rounded to
    bf16 and zeroed on the padding edges; each sum the f32 instance's on
    the widened messages rounded to bf16 (bit-equal), the same bits run
    to run, its plain version within one bf16 ulp; timed beside the plain
    version, ``torch.segment_reduce`` on the same bf16 messages and the
    bound with 2-byte messages and sums -> its entry."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import scatter

    bf16 = torch.bfloat16
    node_cap, edge_cap = capacities_for(train_graphs, BATCH)
    batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                     edge_cap, snug=True)))
    e, f, n = batch.edge_mask.shape[0], 64, batch.nodes.shape[0]
    rng = np.random.default_rng(SEED + 5)
    msgs = rng.standard_normal((e, f)) * batch.edge_mask.numpy()[:, None]
    msgs = torch.from_numpy(msgs.astype(np.float32)).to(dev).to(bf16)
    offsets = scatter.segment_offsets(batch.centers.to(dev), n)
    got = scatter.segment_sum_sorted_bf16_cuda(msgs, offsets)
    again = scatter.segment_sum_sorted_bf16_cuda(msgs, offsets)
    torch.cuda.synchronize()
    check(got.dtype == bf16 and torch.equal(got, again) and torch.equal(
        got, scatter.segment_sum_sorted_cuda(msgs.float(),
                                             offsets).to(bf16)),
        "kernel 6-bf16: not the same bits run to run, or not kernel 6's "
        "sums on the widened messages, rounded")
    errs = compare("segment_sum_sorted_bf16 (one bf16 ulp)", got.float(),
                   scatter.segment_sum_sorted_reference(msgs,
                                                        offsets).float(),
                   BF16_ULP, ATOL)

    def library(x, o):
        return torch.segment_reduce(x, "sum", offsets=o, axis=0,
                                    unsafe=True)

    entry = kernel_entry(
        "segment_sum_sorted_bf16", "segment_sum.cu",
        "cgnn_tpu/ops/pallas_scatter.py:52", errs,
        timings(cold(scatter.segment_sum_sorted_bf16_cuda, msgs, offsets),
                cold(library, msgs, offsets)),
        time_ms(cold(scatter.segment_sum_sorted_reference, msgs, offsets)),
        scatter.segment_sum_cost(e, n, f, elem_bytes=2),
        library_call="torch.segment_reduce(bf16 messages, 'sum', "
                     "offsets=offsets, axis=0, unsafe=True)")
    entry.update(N=n, E=e, F=f, real_edges=int(batch.edge_mask.sum()))
    return entry


def write_label_directories(root, n, seed) -> dict:
    """The heads_modes data: ``n`` MP-like structures written as CIFs with
    ``write_cif_directory`` (id_prop.csv: the synthetic regression
    target) under ``root/reg``, and over the same CIFs (symlinked) two more
    label sets: ``root/cls``, 0/1 by the target above or below the set's
    median; ``root/mt``, four columns after BASELINE config #3
    (formation energy, band gap, bulk and shear modulus; the last three
    seeded functions of the target plus noise, at their own scales), a
    seeded HM_EMPTY of the cells empty (masked labels) -> {name: dir}."""
    import numpy as np

    dirs = {k: os.path.join(root, k) for k in ("reg", "cls", "mt")}
    ids = write_cif_directory(dirs["reg"], n, seed)
    with open(os.path.join(dirs["reg"], "id_prop.csv")) as f:
        target = np.array([float(line.split(",")[1])
                           for line in f.read().split()])
    median = float(np.median(target))
    rng = np.random.default_rng(seed)
    cols = np.stack([
        target,
        np.abs(2.0 + 0.8 * target + rng.normal(0, 0.5, n)),
        np.abs(150.0 + 40.0 * target + rng.normal(0, 20.0, n)),
        np.abs(70.0 + 20.0 * target + rng.normal(0, 10.0, n))], axis=1)
    empty = rng.random(cols.shape) < HM_EMPTY
    empty[np.arange(n), rng.integers(0, 4, n)] = False  # one label a row
    rows = {"cls": [f"{sid},{int(t > median)}" for sid, t in
                    zip(ids, target)],
            "mt": [",".join([sid] + ["" if empty[i, k] else repr(float(v))
                                     for k, v in enumerate(cols[i])])
                   for i, sid in enumerate(ids)]}
    for name, lines in rows.items():
        os.makedirs(dirs[name])
        for sid in ids:
            os.symlink(os.path.join(dirs["reg"], f"{sid}.cif"),
                       os.path.join(dirs[name], f"{sid}.cif"))
        with open(os.path.join(dirs[name], "id_prop.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return dirs | {"empty_share": float(empty.mean())}


def hm_logical(graphs, driver: bool, epochs: int, extra_eval: int = 0):
    """The steps the train entry point takes on ``graphs`` with BATCH, 3
    buckets under the epoch driver (``driver``) or the per-step loop's
    snug batches otherwise -> (train/val/test split, {kind: steps}):
    each epoch every train and validation batch, then the test split's
    eval batches."""
    from cgnn_tpu_torch.data.dataset import train_val_test_split
    from cgnn_tpu_torch.data.graph import (
        bucketed_batch_iterator,
        capacities_for,
        count_batches,
    )

    split = train_val_test_split(graphs, 0.8, 0.1, seed=SEED)
    train_g, val_g, test_g = split
    nc, ec = capacities_for(train_g, BATCH, dense_m=M)
    if driver:
        steps, evals = (sum(1 for _ in bucketed_batch_iterator(
            gs, BATCH, 3, dense_m=M)) for gs in (train_g, val_g))
    else:
        steps, evals = (count_batches(gs, BATCH, nc, ec, snug=True)
                        for gs in (train_g, val_g))
    tests = count_batches(test_g, BATCH, nc, ec, snug=True)
    return split, {"train": epochs * steps,
                   "eval": epochs * evals + tests + extra_eval}


def hm_train(path, argv, cache, driver, per_step, epochs=HM_EPOCHS):
    """The train entry point on one label set, as ``path`` (exact
    launches) -> (its output, its ``train:`` record, the graphs, the
    split)."""
    from cgnn_tpu_torch.data.cache import load_graph_cache
    from cgnn_tpu_torch.train.__main__ import main as train_main

    with PathRun(path) as run:
        rc, out = run_main(train_main, argv, path)
    check(rc == 0, f"{path}: the train entry point exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])
    graphs = load_graph_cache(cache)
    split, logical = hm_logical(graphs, driver, epochs)
    outside = {"predict": info["test"].get("class_eval_batches") or 0}
    check(info["graphs"]["captures_after_warm"] == 0,
          f"{path}: captures after warm-up: {info['graphs']}")
    return out, info, graphs, split, check_path(run, per_step, logical,
                                                outside=outside)


def hm_predict(path, argv, per_step, want, tol, width):
    """The predict entry point as ``path`` (exact launches); its CSV
    against ``want`` [n, width], every entry within ``tol`` x the largest
    |want| (or SERVE_RTOL / SERVE_ATOL when ``tol`` is None) -> (the CSV's
    predictions, its record)."""
    import csv as csvmod

    import numpy as np

    from cgnn_tpu_torch.predict import main as predict_main

    out_csv = argv[argv.index("--out") + 1]
    with PathRun(path) as run:
        rc, out = run_main(predict_main, argv, path)
    check(rc == 0, f"{path}: the predict entry point exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("predict: "))[9:])
    rec = predict_path(run, per_step, info)
    rows = list(csvmod.reader(open(out_csv)))
    n_targets = len(rows[0]) - 1 - width
    got = np.array([[float(x) for x in r[1 + n_targets:]] for r in rows])
    check(got.shape == want.shape, f"{path}: CSV {got.shape}, want "
                                   f"{want.shape}")
    err = np.abs(got - want)
    if tol is None:
        ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
        how = f"rtol {SERVE_RTOL}, atol {SERVE_ATOL}"
    else:
        ok = bool(np.all(err <= tol * np.abs(want).max()))
        how = f"{tol} of the largest |answer|"
    print(f"{path}: {len(rows)} rows x {width} columns, max_abs_err vs the "
          f"plain path {float(err.max())!r} ({how}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{path}: the CSV disagrees with the plain path")
    return got, dict(info, max_abs_err_vs_plain=float(err.max()),
                     path=rec)


def hm_burst(server, label, requests, per_step, want, tol, width):
    """A burst through ``server`` as path ``label``; every answer against
    ``want`` as ``hm_predict`` holds a CSV -> (answers, record)."""
    import numpy as np

    rec = burst(server, requests, label, per_step, width=width)
    got = rec.pop("preds")
    rec.pop("wires")
    err = np.abs(got - want)
    ok = (bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
          if tol is None else bool(np.all(err <= tol * np.abs(want).max())))
    print(f"{label}: {len(requests)} answers x {width}, max_abs_err vs the "
          f"plain path {float(err.max())!r}: {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: answers disagree with the plain path")
    return got, dict(rec, max_abs_err_vs_plain=float(err.max()))


def class_replay_checks(dev, train_g):
    """A classification train step with dropout 0.1 (kernel path) as a
    replayed CUDA graph against the same step run eagerly from the same
    generator state, under deterministic algorithms: every tensor bit for
    bit; then two consecutive replays from the same weights but the
    advanced generator draw different masks (different updates), and the
    generator's offset moves each replay."""
    import torch

    from cgnn_tpu_torch.train.graphs import (
        StepGraph,
        state_generators,
        state_guard,
        tensor_guard,
    )
    from cgnn_tpu_torch.train.step import make_train_step

    _, state, nc, _ = new_state(dev, train_g, cgconv_impl="pallas",
                                classification=True, dropout=0.1)
    batch = fixed_batches(dev, train_g, nc, 1)[0]
    step = make_train_step(classification=True)
    gens = state_generators(state)
    check(len(gens) == 1, f"dropout generators: {gens}")
    gen = gens[0]
    graph = StepGraph(lambda b: step(state, b), batch, device=dev,
                      kind="train", label="class replay",
                      guard=state_guard(state), generators=gens,
                      on_replay=lambda: state.optimizer.advance(1))
    check(graph.graph is not None, "the classification step was not "
                                   "captured")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        restore = state_guard(state)()
        g0 = gen.get_state()
        graph.run(batch)
        replayed = state_bits(state)
        g1 = gen.get_state()
        restore()
        check(torch.equal(gen.get_state(), g0), "restore missed the "
                                                "generator")
        step(state, batch)
        eager = state_bits(state)
        same, worst, where = bits_diff(replayed, eager)
        check(same and torch.equal(gen.get_state(), g1),
              f"replay vs eager from one generator state: max diff "
              f"{worst!r} at {where}")
        # two replays from the same weights: the second draws from where
        # the first left the generator
        restore()
        weights = tensor_guard(lambda: (list(state.model.parameters())
                                        + list(state.model.buffers())
                                        + state.optimizer.tensors()))()
        graph.run(batch)
        first = state_bits(state)
        weights()
        state.optimizer._count = 0
        graph.run(batch)
        second = state_bits(state)
        equal, _, _ = bits_diff(first, second)
        check(not equal and not torch.equal(gen.get_state(), g1),
              "two consecutive replays drew the same mask")
    finally:
        torch.use_deterministic_algorithms(False)
    rec = {"replay_equals_eager_bits": True,
           "consecutive_replays_differ": True,
           "generator_offset_moves": True}
    print(f"classification replay: {rec}: ok")
    return rec


def class_resume_bits(dev, split, work_dir, model_cfg, data_cfg):
    """Resume repeats the uninterrupted run: a classifier with dropout
    0.1 (kernel path, the per-step loop with graphs) trains 2 epochs,
    saving each, then epoch 2 in memory (the uninterrupted run); a fresh
    state restored from the epoch-1 save (weights, optimizer and the
    dropout generator) runs the same epoch 2: bit-equal in every tensor
    and the generator, under deterministic algorithms."""
    import shutil

    import torch

    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.graphs import state_generators
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    ck = os.path.join(work_dir, "hm_class_resume")
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(ck, keep=0)
    meta = {"model": model_cfg.to_meta(), "data": data_cfg.to_meta(),
            "task": "classification"}
    kw = dict(cgconv_impl="pallas", classification=True, dropout=0.1)

    def run(state, start, end, save):
        return fit(state, train_g, val_g, epochs=end, batch_size=BATCH,
                   dense_m=M, device=dev, seed=SEED, start_epoch=start,
                   on_epoch_end=(lambda s, e, vm, best: mgr.save(
                       s, dict(meta, epoch=e), is_best=best)) if save
                   else None, log_fn=lambda *_: None)[0]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, state, _, _ = new_state(dev, train_g, **kw)
        state = run(state, 0, 2, True)
        mgr.wait()
        state = run(state, 2, 3, False)
        uninterrupted = state_bits(state)
        gen_u = state_generators(state)[0].get_state()
        _, fresh, _, _ = new_state(dev, train_g, **kw)
        _, saved = mgr.restore(fresh)
        check(saved["epoch"] == 1, f"restored epoch {saved['epoch']}")
        fresh = run(fresh, 2, 3, False)
        same, worst, where = bits_diff(state_bits(fresh), uninterrupted)
        gen_same = torch.equal(state_generators(fresh)[0].get_state(),
                               gen_u)
    finally:
        torch.use_deterministic_algorithms(False)
        mgr.close()
    check(same and gen_same, f"the resumed classifier leaves the "
                             f"uninterrupted run: max diff {worst!r} at "
                             f"{where}, generator equal {gen_same}")
    print("classification resume: epoch 2 from the restored save vs the "
          "uninterrupted run: bit-equal, generator equal: ok")
    return {"resumed_bits_equal": True, "generator_equal": True}


def heads_modes_phase(dev, work_dir, card, calibration):
    """The heads and modes at full width (F=64, 3 convs, h=128, M=12,
    8 A, G=41, batch 256) on MP-like CIFs (``write_label_directories``):

    - bf16: the train entry point ``DIR --cache --bf16 --cgconv-impl
      pallas --device-resident --buckets 3`` under the epoch driver, its
      compact staging 'auto' (path ``hm_bf16_driver``: only the bf16
      instances of kernels 1, 2, 4 and 5 launch, exactly; no capture after
      warm-up); the staged bytes of full staging in bf16 against f32 on
      the same batches; a 5-step kernel-path vs plain-path trajectory in
      bf16; the saved checkpoint through the predict entry point on the
      featurized (``hm_bf16_predict``), compact (``hm_bf16_predict_compact``)
      and raw (``hm_bf16_predict_raw``, kernel 8 unchanged) wires and
      ``load_server`` (``hm_bf16_serve``: featurized graphs staged
      compactly; ``hm_bf16_serve_raw``: wire structures), every answer
      within BF16_TOL of the bf16 plain path on host-featurized copies, and
      its gap to the f32 model on the same weights reported;
    - classification: 0/1 labels by the median, ``--task classification
      --dropout 0.1 --cgconv-impl pallas`` under the driver
      (``hm_class_driver``; the ``class_eval`` line printed), a replay
      against eager from one generator state and two replays' masks
      (``class_replay_checks``), resume bits (``class_resume_bits``) and
      ``--resume`` (``hm_class_resume``), then predict
      (``hm_class_predict``) and serve (``hm_class_serve``): 2 columns of
      log-probs whose exp sums to 1 within 1e-5, held to the plain path;
    - multi-task: 4 columns, about a quarter of the cells empty,
      ``--multi-task-head --n-h 2 --cgconv-impl pallas`` in the per-step
      loop (``hm_multitask``; the per-task MAE lines printed) and served
      (``hm_multitask_serve``: 4 columns, held to the plain path).
    -> (summary, counts by path)."""
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.graph import (
        bucketed_batch_iterator,
        capacities_for,
    )
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.loop import edge_pack_fn, staged_nbytes

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "heads_modes")
    shutil.rmtree(root, ignore_errors=True)
    dirs = write_label_directories(root, N_HM, SEED + 13)
    data_cfg = DataConfig()
    n_conv = ModelConfig().n_conv
    f32_steps = dense_per_step(n_conv)
    bf16_steps = dense_per_step(n_conv, bf16=True)
    counts, summary = {}, {"card": card, "structures": N_HM,
                           "multi_task_empty_share": dirs["empty_share"]}

    def base(name):
        return [dirs[name], "--cache", os.path.join(root, f"{name}.npz"),
                "-j", str(PREPROCESS_WORKERS), "-b", str(BATCH),
                "--epochs", str(HM_EPOCHS), "--print-freq", "0", "--seed",
                str(SEED), "--ckpt-dir", os.path.join(root, f"{name}_ck"),
                "--out-dir", os.path.join(root, f"{name}_out")]

    # --- bf16 -------------------------------------------------------------
    out, info, graphs, split, counts["hm_bf16_driver"] = hm_train(
        "hm_bf16_driver", base("reg") + [
            "--bf16", "--cgconv-impl", "pallas", "--device-resident",
            "--buckets", "3"],
        os.path.join(root, "reg.npz"), True, bf16_steps)
    st = info["staging"]
    check(st["compact"] and "compact staging: on" in out,
          f"hm_bf16_driver: staging {st}")
    train_g = split[0]
    full = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        full[name] = staged_nbytes(list(bucketed_batch_iterator(
            train_g, BATCH, 3, shuffle=True, rng=np.random.default_rng(SEED),
            dense_m=M, pack_fn=edge_pack_fn(dtype))))
    summary["bf16_driver"] = {
        "staged_bytes_compact": st["staged_bytes"],
        "full_staging_bytes_bf16": full["bf16"],
        "full_staging_bytes_f32": full["f32"],
        "full_staging_bf16_over_f32": full["bf16"] / full["f32"],
        "epoch_seconds": info["epoch_seconds"],
        "train_structures_per_s": info["train_structures_per_s"],
        "captures_after_warm": info["graphs"]["captures_after_warm"],
        "test": info["test"]}
    print(f"hm_bf16_driver: {summary['bf16_driver']}")
    _, traj = compare_trajectories(
        dev, train_g, fixed_batches(
            dev, train_g, capacities_for(train_g, BATCH, dense_m=M)[0], 5,
            edge_dtype=torch.bfloat16),
        "bf16 trajectory", {"cgconv_impl": "pallas", "dtype": "bfloat16"},
        {"cgconv_impl": "", "dtype": "bfloat16"}, rtol=BF16_TOL,
        atol=BF16_ATOL)
    summary["bf16_trajectory"] = traj
    ck = os.path.join(root, "reg_ck")
    want = plain_answers(dev, ck, "latest", graphs)
    want32 = plain_answers(dev, ck, "latest", graphs, dtype="float32")
    preds = {}
    cache = os.path.join(root, "reg.npz")
    for path, extra in (
            ("hm_bf16_predict", ["--cache", cache, "--compact", "off",
                                 "--wire", "featurized"]),
            ("hm_bf16_predict_compact", ["--cache", cache, "--compact", "on",
                                         "--wire", "featurized"]),
            ("hm_bf16_predict_raw", [dirs["reg"], "--wire", "raw"])):
        got, rec = hm_predict(
            path, [ck, *extra, "-b", str(BATCH), "--out",
                   os.path.join(root, f"{path}.csv")],
            bf16_steps, want, BF16_TOL, 1)
        counts[path] = rec.pop("path")
        rec["max_abs_gap_to_f32_model"] = float(np.abs(got - want32).max())
        preds[path] = rec
    check(preds["hm_bf16_predict_raw"]["batches_raw"] > 0
          and preds["hm_bf16_predict_compact"]["compact"],
          f"bf16 predict wires: {preds}")
    summary["bf16_predict"] = preds
    server, _ = load_server(ck, wire="raw", compact="on",
                            calibration=calibration, device=dev,
                            log_fn=lambda *_: None, watch=False)
    # the first CIFs' structures in wire form (write_cif_directory's
    # generator and seed), and their host-featurized copies
    wire = list(synthetic_mp_dataset(N_HM_RAW, seed=SEED + 13))
    raws = [RawStructure.from_structure(st, cif_id=sid)
            for sid, st, _ in wire]
    featurize = structure_featurizer(data_cfg)
    geo = [featurize(st) for _, st, _ in wire]
    serve_g = graphs[:N_HM_SERVE]
    serves = {}
    for label, reqs, ref_g in (("hm_bf16_serve", serve_g, serve_g),
                               ("hm_bf16_serve_raw", raws, geo)):
        w = plain_answers(dev, ck, "latest", ref_g)
        w32 = plain_answers(dev, ck, "latest", ref_g, dtype="float32")
        got, rec = hm_burst(server, label, reqs, bf16_steps, w, BF16_TOL, 1)
        counts[label] = rec.pop("path")
        rec["max_abs_gap_to_f32_model"] = float(np.abs(got - w32).max())
        serves[label] = rec
    check(serves["hm_bf16_serve_raw"]["raw_flushes"] > 0,
          "the bf16 raw burst ran no raw flush")
    check(server.drain(timeout_s=60), "the bf16 server did not drain")
    summary["bf16_serve"] = serves

    # --- classification ---------------------------------------------------
    out, info, graphs, split, counts["hm_class_driver"] = hm_train(
        "hm_class_driver", base("cls") + [
            "--task", "classification", "--dropout", "0.1",
            "--cgconv-impl", "pallas", "--device-resident", "--buckets",
            "3"], os.path.join(root, "cls.npz"), True, f32_steps)
    check("** test accuracy" in out and info["test"].get("accuracy")
          is not None, "hm_class_driver: no class_eval line")
    cls_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas",
                          classification=True, dropout=0.1)
    summary["class_driver"] = {"test": info["test"],
                               "epoch_seconds": info["epoch_seconds"]}
    summary["class_replay"] = class_replay_checks(dev, split[0])
    summary["class_resume"] = class_resume_bits(dev, split, work_dir,
                                                cls_cfg, data_cfg)
    ck = os.path.join(root, "cls_ck")
    with PathRun("hm_class_resume") as run:
        rc, out = run_main(train_main, base("cls") + [
                               "--task", "classification", "--dropout",
                               "0.1", "--cgconv-impl", "pallas",
                               "--device-resident", "--buckets", "3",
                               "--epochs", str(HM_EPOCHS + 1),
                               "--resume", ck], "hm_class_resume")
    check(rc == 0 and f"resumed from {ck} at epoch {HM_EPOCHS}" in out,
          f"hm_class_resume: rc {rc}, {out[-300:]!r}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])
    _, logical = hm_logical(graphs, True, 1)
    counts["hm_class_resume"] = check_path(
        run, f32_steps, logical,
        outside={"predict": info["test"]["class_eval_batches"]})
    want = plain_answers(dev, ck, "latest", graphs)
    got, rec = hm_predict("hm_class_predict", [
        ck, "--cache", os.path.join(root, "cls.npz"), "-b", str(BATCH),
        "--out", os.path.join(root, "hm_class_predict.csv")],
        f32_steps, want, None, 2)
    counts["hm_class_predict"] = rec.pop("path")
    sums = np.exp(got).sum(axis=1)
    check(bool(np.all(np.abs(sums - 1.0) <= 1e-5)),
          f"predicted class probabilities sum to {sums.min()}..{sums.max()}")
    server, _ = load_server(ck, calibration=calibration, device=dev,
                            log_fn=lambda *_: None, watch=False)
    got_s, srec = hm_burst(server, "hm_class_serve", graphs[:N_HM_SERVE],
                           f32_steps, want[:N_HM_SERVE], None, 2)
    counts["hm_class_serve"] = srec.pop("path")
    check(server.drain(timeout_s=60), "the classifier's server did not "
                                      "drain")
    ssums = np.exp(got_s).sum(axis=1)
    check(bool(np.all(np.abs(ssums - 1.0) <= 1e-5)),
          f"served class probabilities sum to {ssums.min()}..{ssums.max()}")
    summary["class_predict"] = dict(rec, max_prob_sum_gap=float(
        np.abs(sums - 1.0).max()))
    summary["class_serve"] = dict(srec, max_prob_sum_gap=float(
        np.abs(ssums - 1.0).max()))

    # --- multi-task -------------------------------------------------------
    out, info, graphs, _, counts["hm_multitask"] = hm_train(
        "hm_multitask", base("mt") + [
            "--multi-task-head", "--n-h", "2", "--cgconv-impl", "pallas"],
        os.path.join(root, "mt.npz"), False, f32_steps)
    check(all(f"** test mae task {t}:" in out for t in range(4)),
          "hm_multitask: per-task MAE lines missing")
    ck = os.path.join(root, "mt_ck")
    want = plain_answers(dev, ck, "latest", graphs[:N_HM_SERVE])
    server, _ = load_server(ck, calibration=calibration, device=dev,
                            log_fn=lambda *_: None, watch=False)
    _, srec = hm_burst(server, "hm_multitask_serve", graphs[:N_HM_SERVE],
                       f32_steps, want, None, 4)
    counts["hm_multitask_serve"] = srec.pop("path")
    check(server.drain(timeout_s=60), "the multi-task server did not drain")
    summary["multitask"] = {
        "test": info["test"], "serve": srec,
        "test_mae_by_task": {HM_TASKS[t]: info["test"].get(f"mae_task{t}")
                             for t in range(4)}}
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"heads_modes: {summary['seconds']!r} s")
    return summary, counts


N_BF16_PATHS = 1024  # --synthetic cells of the bf16_coo and bf16_epilogue
BF16_PATH_EPOCHS = 2  # paths (small cells, 2-12 atoms), and their epochs
N_BF16_PREDICT = 256  # structures predicted on each bf16 path
N_FORCE = 1024  # --synthetic LJ frames of the force task
FORCE_ATOMS = 21  # MD17 aspirin's atom count
FORCE_EPOCHS = 3
N_FORCE_BITS = 512  # frames of the in-process bit checks (train part)
FD_STEP = 1e-4  # the central difference's step, in A (f64)
FD_RTOL = 1e-5  # |F - F_fd| within this of the largest |F| (f64)
N_OC20 = 256  # --synthetic-oc20 slabs (37-255 atoms)
OC20_BATCH = 64


def entry_logical(split, dense_m, epochs, batch=None, snug=True,
                  caps=None):
    """The steps the train entry point takes on a split (the per-step
    loop, or the epoch driver with one bucket), its batches snug or, with
    ``snug=False``, the ladder's, at the training graphs' capacities or
    ``caps`` (node_cap, edge_cap): each epoch every train and validation
    batch, then the test split's eval batches -> {kind: steps}."""
    from cgnn_tpu_torch.data.graph import capacities_for, count_batches

    batch = batch or BATCH
    train_g, val_g, test_g = split
    nc, ec = caps or capacities_for(train_g, batch, dense_m=dense_m,
                                    snug=snug)
    steps, evals, tests = (count_batches(gs, batch, nc, ec, snug=snug)
                           for gs in (train_g, val_g, test_g))
    return {"train": epochs * steps, "eval": epochs * evals + tests}


def entry_train(path, argv, per_step, logical):
    """The train entry point as ``path`` (exact launches) -> (its output,
    its ``train:`` record, the path's record)."""
    from cgnn_tpu_torch.train.__main__ import main as train_main

    with PathRun(path) as run:
        rc, out = run_main(train_main, argv, path)
    check(rc == 0, f"{path}: the train entry point exited {rc}")
    info = json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])
    check(info["graphs"]["captures_after_warm"] == 0,
          f"{path}: captures after warm-up: {info['graphs']}")
    return out, info, check_path(run, per_step, logical)


def bf16_paths_phase(dev, work_dir, card, calibration):
    """The bf16 instances of kernels 3 and 6 on their paths, at full width
    (F=64, 3 convs, h=128, M=12, 8 A, G=41, batch 256) on N_BF16_PATHS
    synthetic cells:

    - ``bf16_coo``: the train entry point ``--layout coo --aggregation
      pallas --bf16`` (path ``bf16_coo_train``: kernel 6's bf16 instance
      in every aggregation and in the gathers' backward, exactly, no f32
      instance), the predict entry point (``bf16_coo_predict``) and a
      burst through ``load_server`` on the COO ladder
      (``bf16_coo_serve``);
    - ``bf16_epilogue``: ``--fused-epilogue pallas --bf16``
      (``bf16_epilogue_train``: kernel 3's bf16 instance a conv in every
      forward, with 4-bf16 and 5-bf16 in the backward, no f32 instance),
      then predict (``bf16_epilogue_predict``, raw wire included);

    every answer within BF16_TOL of the largest |answer| of the bf16 plain
    path (``plain_answers``) -> (summary, counts by path)."""
    import shutil

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.serve.server import load_server

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "bf16_paths")
    shutil.rmtree(root, ignore_errors=True)
    fcfg = DataConfig().featurize_config()
    graphs = load_synthetic(N_BF16_PATHS, fcfg, seed=SEED)
    split = train_val_test_split(graphs, 0.8, 0.1, seed=SEED)
    pred_g = load_synthetic(N_BF16_PREDICT, fcfg, seed=SEED)
    n_conv = ModelConfig().n_conv
    counts, summary = {}, {"card": card, "structures": N_BF16_PATHS}
    for name, layout, per_step, dense_m in (
            ("bf16_coo", ["--layout", "coo", "--aggregation", "pallas"],
             coo_per_step(n_conv, bf16=True), None),
            ("bf16_epilogue", ["--fused-epilogue", "pallas"],
             dense_per_step(n_conv, epilogue=True, bf16=True), M)):
        ck = os.path.join(root, f"{name}_ck")
        out, info, counts[f"{name}_train"] = entry_train(
            f"{name}_train", [
                "--synthetic", str(N_BF16_PATHS), "--bf16", *layout, "-b",
                str(BATCH), "--epochs", str(BF16_PATH_EPOCHS),
                "--print-freq", "0", "--seed", str(SEED), "--ckpt-dir", ck,
                "--out-dir", os.path.join(root, f"{name}_out")],
            per_step, entry_logical(split, dense_m, BF16_PATH_EPOCHS))
        want = plain_answers(dev, ck, "latest", pred_g)
        _, rec = hm_predict(
            f"{name}_predict", [ck, "--synthetic", str(N_BF16_PREDICT), "-b",
                                str(BATCH), "--out",
                                os.path.join(root, f"{name}.csv")],
            per_step, want, BF16_TOL, 1)
        counts[f"{name}_predict"] = rec.pop("path")
        summary[name] = {"train_structures_per_s":
                         info["train_structures_per_s"],
                         "epoch_seconds": info["epoch_seconds"],
                         "test": info["test"], "predict": rec}
        if name == "bf16_coo":
            server, _ = load_server(ck, calibration=calibration, device=dev,
                                    log_fn=lambda *_: None, watch=False)
            _, srec = hm_burst(server, "bf16_coo_serve",
                               pred_g[:N_HM_SERVE], per_step,
                               want[:N_HM_SERVE], BF16_TOL, 1)
            counts["bf16_coo_serve"] = srec.pop("path")
            check(server.drain(timeout_s=60),
                  "the bf16 COO server did not drain")
            summary[name]["serve"] = srec
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"bf16_paths: {summary['seconds']!r} s")
    return summary, counts


def free_card_memory() -> dict:
    """Hand the allocator's unused cached blocks (ended phases' graph
    pools and batches) back to the card, so a later capture's pool can
    take them -> {allocated, reserved} GiB after it, and what a
    ``gc.collect()`` before it freed of the allocation: nothing, now that
    no graph, driver or server sits in a reference cycle (PERF.md §7)."""
    import gc

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    return {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "collect_freed_gib": freed / 2**30}


def force_state(dev, train_g, dense_m, dtype="float32"):
    """A fresh force-field TrainState at full width (Adam, lr 2e-3, the
    numpy-seeded init), as the train entry point makes one."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.state import init_train_state

    return init_train_state(
        ModelConfig(dense_m=dense_m or 0, dtype=dtype), DataConfig(),
        train_g, batch_size=BATCH, device=dev, seed=SEED, optim="adam",
        lr=2e-3, task="force")[0]


def force_replay_bits(dev, train_g):
    """A force train step (forces with ``create_graph``, then the
    composite loss's backward) captured as a StepGraph and replayed over
    3 full-width batches against the same steps run eagerly, under
    deterministic algorithms: every tensor bit-equal, the metric sums
    equal -> record."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.train.force_step import make_force_train_step
    from cgnn_tpu_torch.train.graphs import StepGraph, state_guard
    from cgnn_tpu_torch.train.metrics import DeviceSums, fetch_device_sums

    nc, ec = capacities_for(train_g, BATCH, dense_m=M)
    batches = [b.to(dev) for b in batch_iterator(train_g, BATCH, nc, ec,
                                                 dense_m=M, snug=True)][:3]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, replayed = (force_state(dev, train_g, M) for _ in range(2))
        step, sums, gsums = make_force_train_step(), DeviceSums(), \
            DeviceSums()
        for b in batches:
            sums.add(step(eager, b))
        before = state_bits(replayed)
        g = StepGraph(lambda b: gsums.add(step(replayed, b)), batches[0],
                      device=dev, kind="train",
                      guard=state_guard(replayed, sums=[gsums]),
                      on_replay=lambda: replayed.optimizer.advance(1))
        check(g.graph is not None, "the force train step was not captured")
        same, _, where = bits_diff(state_bits(replayed), before)
        check(same, f"the capture changed the state at {where}")
        gsums.zero()
        for b in batches:
            g.run(b)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    same, worst, where = bits_diff(state_bits(replayed), state_bits(eager))
    want, got = fetch_device_sums(sums.sums), fetch_device_sums(gsums.sums)
    check(same and want == got, f"the replayed force step leaves the eager "
                                f"one: max diff {worst!r} at {where}; sums "
                                f"{got} vs {want}")
    print(f"force replay vs eager over {len(batches)} batches: bit-equal, "
          f"sums equal: ok")
    return {"batches": len(batches), "bit_equal": True, "sums": got}


def force_fit_bits(dev, split, work_dir):
    """Two in-process runs of the epoch driver (2 epochs, dense, graphs
    on, N_FORCE_BITS training frames) from the same init, bit-equal; then
    resume: epochs 0-1 saved, epoch 2 in memory against a fresh state
    restored from the epoch-1 save, bit-equal; all under deterministic
    algorithms -> record."""
    import shutil

    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g = split[0][:N_FORCE_BITS], split[1][:BATCH]
    ck = os.path.join(work_dir, "force_resume_bits")
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(ck, keep=0)
    meta = {"model": ModelConfig(dense_m=M).to_meta(),
            "data": DataConfig().to_meta(), "task": "force"}

    def run(state, start, end, save=False):
        return fit(state, train_g, val_g, epochs=end, batch_size=BATCH,
                   dense_m=M, device=dev, seed=SEED, start_epoch=start,
                   scan_epochs=True, on_epoch_end=(
                       lambda s, e, vm, best: mgr.save(
                           s, dict(meta, epoch=e), is_best=best))
                   if save else None, log_fn=lambda *_: None)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, res = run(force_state(dev, train_g, M), 0, 2, save=True)
        check(res["graphs"]["captures_after_warm"] == 0
              and res["graphs"]["replays"] > 0, f"fit graphs {res}")
        mgr.wait()
        second, _ = run(force_state(dev, train_g, M), 0, 2)
        twice, worst, where = bits_diff(state_bits(first),
                                        state_bits(second))
        check(twice, f"two force runs differ: {worst!r} at {where}")
        first, _ = run(first, 2, 3)
        fresh = force_state(dev, train_g, M)
        _, saved = mgr.restore(fresh)
        check(saved["epoch"] == 1, f"restored epoch {saved['epoch']}")
        fresh, _ = run(fresh, 2, 3)
        resumed, worst, where = bits_diff(state_bits(fresh),
                                          state_bits(first))
    finally:
        torch.use_deterministic_algorithms(False)
        mgr.close()
    check(resumed, f"the resumed force epoch leaves the uninterrupted one: "
                   f"{worst!r} at {where}")
    print("force: two driver runs bit-equal; the resumed epoch bit-equal to "
          "the uninterrupted one: ok")
    return {"two_runs_bit_equal": True, "resumed_bit_equal": True,
            "frames": len(train_g)}


def force_central_difference(dev, ck, test_g):
    """The trained model (``ck``, latest) in f64 on the card: its forces
    on a test batch against a central difference of the energy on a few
    atoms (step FD_STEP), within FD_RTOL of the largest |F|; beside it the
    f32 model's forces' gap to the f64 ones -> record."""
    import dataclasses as dc

    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.models.forcefield import energy_and_forces
    from cgnn_tpu_torch.train.checkpoint import load_for_inference

    state, _, _ = load_for_inference(ck, "latest", dev)
    model = state.model
    nc, ec = capacities_for(test_g, 16, dense_m=M)
    batch = next(iter(batch_iterator(test_g, 16, nc, ec, dense_m=M,
                                     snug=True))).to(dev)
    _, f32_forces = energy_and_forces(model, batch)
    model = model.double()
    b64 = dc.replace(batch, positions=batch.positions.double(),
                     lattices=batch.lattices.double(),
                     edge_offsets=batch.edge_offsets.double())
    _, forces = energy_and_forces(model, b64)
    pos = b64.positions
    worst, scale = 0.0, float(forces.abs().max())
    atoms = [0, 5, FORCE_ATOMS + 3, 2 * FORCE_ATOMS + 10]
    with torch.no_grad():
        for atom in atoms:
            for axis in range(3):
                e = []
                for sign in (1.0, -1.0):
                    p = pos.clone()
                    p[atom, axis] += sign * FD_STEP
                    e.append(float(model(b64, p).sum()))
                fd = -(e[0] - e[1]) / (2 * FD_STEP)
                worst = max(worst, abs(fd - float(forces[atom, axis])))
    gap32 = float((f32_forces.double() - forces).abs().max())
    ok = worst <= FD_RTOL * scale
    print(f"force central difference (f64, h={FD_STEP}, {len(atoms)} atoms "
          f"x 3): max |F - F_fd| {worst!r} against max |F| {scale!r} "
          f"(rtol {FD_RTOL}): {'ok' if ok else 'FAIL'}; f32 forces' gap to "
          f"f64 {gap32!r}")
    check(ok, "the force field's forces are not -dE/dr")
    return {"max_abs_err": worst, "max_abs_force": scale, "step": FD_STEP,
            "atoms": len(atoms), "f32_gap_to_f64": gap32}


def force_step_split(dev, train_g):
    """Device time of one full-width force train step split in its
    parts, on the first training batch: the energy forward, the forward
    with the forces (``create_graph``), and those with the composite
    loss's backward to the parameters (the double backward); eager, the
    profiler's device time (events as well) -> record with the double
    backward's share."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.models.forcefield import energy_and_forces
    from cgnn_tpu_torch.train.force_step import force_loss

    state = force_state(dev, train_g, M)
    model = state.model.train()
    nc, ec = capacities_for(train_g, BATCH, dense_m=M)
    batch = next(iter(batch_iterator(train_g, BATCH, nc, ec, dense_m=M,
                                     snug=True))).to(dev)
    params = list(state.optimizer.params)

    def forward():
        with torch.no_grad():
            model(batch)

    def forces():
        energy_and_forces(model, batch, create_graph=True)

    def full():
        e, f = energy_and_forces(model, batch, create_graph=True)
        loss, _ = force_loss(e, f, batch, state.normalizer)
        grads = torch.autograd.grad(loss, params)
        del grads

    rec = {}
    for name, fn in (("forward", forward), ("forces", forces),
                     ("step_no_update", full)):
        rec[f"{name}_device_ms"] = device_ms(fn)
        rec[f"{name}_ms"] = time_ms(fn, calls=10, trials=3)
    for how, sfx in (("device", "_device_ms"), ("events", "_ms")):
        step_t, forces_t = rec[f"step_no_update{sfx}"], rec[f"forces{sfx}"]
        rec[f"double_backward_share_{how}"] = (
            None if step_t is None or forces_t is None
            else (step_t - forces_t) / step_t)
    rec["N"] = int(batch.nodes.shape[0])
    print(f"force step split: {rec}")
    return rec


def force_task_phase(dev, work_dir, card):
    """The force task at full width (F=64, 3 convs, h=128, M=12, 8 A,
    G=41, batch 256) on N_FORCE synthetic LJ frames of FORCE_ATOMS atoms
    (MD17 aspirin's count), split in contiguous blocks:

    - the train entry point under the epoch driver, dense
      (``force_driver``), COO with ``--aggregation xla`` (``force_coo``)
      and dense bf16 (``force_bf16``), FORCE_EPOCHS epochs each: every
      step a replayed CUDA graph (exact step counts; no kernel of the
      port's launches on these paths: the force task runs none, as the
      JAX package's runs no Pallas kernel), no capture after warm-up;
      their rates;
    - ``--resume`` (``force_resume``); the predict entry point on the
      test split (``force_predict``: every batch a replay; the CSV's
      energies and ``.forces.npz`` against the eager predict step, rtol
      1e-4 / atol 1e-4);
    - a replayed step bit-equal to eager, two runs bit-equal, a resumed
      epoch bit-equal (deterministic algorithms); forces against a
      central difference of E in f64; the step's split;
    - the refusals: ``load_server`` and the serve entry point on a force
      checkpoint, ``--aggregation pallas``, ``--compact-staging on``;
    - the regression task on N_OC20 OC20-like slabs (``oc20_train``,
      kernel path, per-step loop).
    -> (summary, counts by path)."""
    import csv as csvmod
    import shutil

    import numpy as np

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.cache import save_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_oc20,
        load_trajectory,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.data.trajectory import split_trajectory_groups
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.serve.__main__ import main as serve_main
    from cgnn_tpu_torch.serve.server import FORCE_SERVE_REFUSAL, load_server
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import load_for_inference
    from cgnn_tpu_torch.train.force_step import make_force_predict_step

    t_phase = time.perf_counter()
    # the last phase: what earlier phases left cached goes back first
    memory_at_start = free_card_memory()
    print(f"force_task: card memory at the start {memory_at_start}")
    root = os.path.join(work_dir, "force")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    fcfg = DataConfig().featurize_config()
    t0 = time.perf_counter()
    graphs = load_trajectory(N_FORCE, fcfg, seed=SEED,
                             num_atoms=FORCE_ATOMS)
    split = split_trajectory_groups([graphs], 0.8, 0.1, seed=SEED)
    counts = {}
    summary = {"card": card, "frames": N_FORCE, "atoms": FORCE_ATOMS,
               "featurize_s": time.perf_counter() - t0,
               "split": [len(s) for s in split],
               "card_memory_at_start": memory_at_start}
    base = ["--task", "force", "--synthetic", str(N_FORCE), "--md-atoms",
            str(FORCE_ATOMS), "-b", str(BATCH), "--optim", "Adam", "--lr",
            "0.002", "--print-freq", "0", "--seed", str(SEED)]

    def ck_args(name, epochs=FORCE_EPOCHS):
        ck = os.path.join(root, name)
        return ["--epochs", str(epochs), "--ckpt-dir", ck, "--out-dir",
                ck + "_out"]

    rates = {}
    for name, extra, dense_m in (
            ("force_driver", [], M),
            ("force_coo", ["--layout", "coo", "--aggregation", "xla"], None),
            ("force_bf16", ["--bf16"], M)):
        free_card_memory()
        out, info, counts[name] = entry_train(
            name, base + ["--device-resident", *extra] + ck_args(name), {},
            entry_logical(split, dense_m, FORCE_EPOCHS))
        check("** test force_mae" in out and "** test energy mae" in out
              and "trajectory-aware split" in out, f"{name}: output lines")
        check(info["graphs"]["replays"] > 0, f"{name}: no replay")
        rates[name] = {
            "train_structures_per_s": info["train_structures_per_s"],
            "steady_structures_per_s": len(split[0]) * (FORCE_EPOCHS - 1)
            / sum(info["epoch_seconds"][1:]),
            "epoch_seconds": info["epoch_seconds"],
            "staged_bytes": info["staging"]["staged_bytes"],
            "graphs": info["graphs"], "test": info["test"]}
    summary["rates"] = rates
    print(f"force rates: {json.dumps(rates, allow_nan=False)}")

    ck = os.path.join(root, "force_driver")
    free_card_memory()
    out, info, counts["force_resume"] = entry_train(
        "force_resume", base + ["--device-resident", "--resume", ck]
        + ck_args("force_driver", FORCE_EPOCHS + 1), {},
        entry_logical(split, M, 1))
    check(f"resumed from {ck} at epoch {FORCE_EPOCHS}" in out,
          "force_resume did not resume")

    test_g = split[2]
    cache = os.path.join(root, "test.npz")
    save_graph_cache(test_g, cache)
    out_csv = os.path.join(root, "force_predict.csv")
    with PathRun("force_predict") as run:
        rc, out = run_main(predict_main, [ck, "--cache", cache, "-b",
                                          str(BATCH), "--out", out_csv],
                           "force_predict")
    check(rc == 0, f"force_predict exited {rc}")
    pinfo = json.loads(next(line for line in out.splitlines()
                            if line.startswith("predict: "))[9:])
    counts["force_predict"] = check_path(run, {},
                                         {"predict": pinfo["batches"]})
    check(pinfo["replays"] == pinfo["batches"], f"force_predict {pinfo}")
    rows = list(csvmod.reader(open(out_csv)))
    z = np.load(out_csv + ".forces.npz")
    check(len(rows) == len(test_g) and list(z["ids"]) == [
        g.cif_id for g in test_g], "force_predict: rows or ids")
    state, _, _ = load_for_inference(ck, "latest", dev)
    step = make_force_predict_step()
    nc, ec = capacities_for(test_g, BATCH, dense_m=M)
    want_e, want_f = [], []
    for b in batch_iterator(test_g, BATCH, nc, ec, dense_m=M, snug=True):
        e, f = step(state, b.to(dev))
        e, f = e.cpu().numpy(), f.cpu().numpy()
        mask = b.node_mask.numpy() > 0
        for k in range(int(b.graph_mask.sum())):
            want_e.append(e[k])
            want_f.append(f[(b.node_graph.numpy() == k) & mask])
    got_e = np.array([float(r[2]) for r in rows])
    err_e = float(np.abs(got_e - np.array(want_e)).max())
    err_f = max(float(np.abs(z[f"forces_{i}"] - w).max())
                for i, w in enumerate(want_f))
    check(all(z[f"forces_{i}"].shape == (FORCE_ATOMS, 3)
              for i in range(len(rows))), "force_predict: force shapes")
    check(np.allclose(got_e, want_e, rtol=SERVE_RTOL, atol=SERVE_ATOL)
          and all(np.allclose(z[f"forces_{i}"], w, rtol=SERVE_RTOL,
                              atol=SERVE_ATOL)
                  for i, w in enumerate(want_f)),
          f"force_predict vs the eager step: energies {err_e!r}, forces "
          f"{err_f!r}")
    summary["predict"] = dict(pinfo, max_abs_err_energy_vs_eager=err_e,
                              max_abs_err_forces_vs_eager=err_f)

    for key, fn, args in (
            ("replay", force_replay_bits, (dev, split[0])),
            ("bits", force_fit_bits, (dev, split, work_dir)),
            ("central_difference", force_central_difference,
             (dev, ck, test_g)),
            ("step_split", force_step_split, (dev, split[0]))):
        free_card_memory()
        summary[key] = fn(*args)

    refusals = {}
    try:
        load_server(ck, device=dev, warm=False, watch=False,
                    log_fn=lambda *_: None)
        refusals["load_server"] = "served"
    except NotImplementedError as e:
        refusals["load_server"] = str(e)
    refusals["serve_entry_rc"] = run_main(serve_main, [ck, "--port", "0"],
                                          "force_serve")[0]
    for key, extra in (("aggregation_pallas_rc",
                        ["--layout", "coo", "--aggregation", "pallas"]),
                       ("compact_on_rc", ["--device-resident",
                                          "--compact-staging", "on"])):
        refusals[key] = run_main(train_main, base + extra + ck_args(
            "refused", 1), f"force_{key}")[0]
    check(refusals == {"load_server": FORCE_SERVE_REFUSAL,
                       "serve_entry_rc": 2, "aggregation_pallas_rc": 2,
                       "compact_on_rc": 2}, f"force refusals: {refusals}")
    summary["refusals"] = refusals

    oc20 = load_synthetic_oc20(N_OC20, fcfg, seed=SEED)
    free_card_memory()
    out, info, counts["oc20_train"] = entry_train(
        "oc20_train", ["--synthetic-oc20", str(N_OC20), "--cgconv-impl",
                       "pallas", "-b", str(OC20_BATCH), "--epochs", "2",
                       "--print-freq", "0", "--seed", str(SEED)]
        + ck_args("oc20", 2), dense_per_step(ModelConfig().n_conv),
        entry_logical(train_val_test_split(oc20, 0.8, 0.1, seed=SEED), M,
                      2, batch=OC20_BATCH))
    summary["oc20"] = {"atoms": [min(g.num_nodes for g in oc20),
                                 max(g.num_nodes for g in oc20)],
                       "train_structures_per_s":
                       info["train_structures_per_s"], "test": info["test"]}
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"force_task: {summary['seconds']!r} s")
    return summary, counts


# the observe phase's training runs: the entry point's small cells (2
# train steps an epoch at batch 256), epochs enough for a rate over
# epochs 2 on without featurizing more structures
OBS_EPOCHS = 8
N_OBS_HTTP = 96  # requests of each wire in the observe phase's burst


def http_text(port, path) -> tuple:
    """One GET on a new connection -> (status, content type, text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def save_tree_bits(ck) -> dict:
    """Every array of the newest committed save of ``ck``, by path."""
    from cgnn_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_tree,
    )

    mgr = CheckpointManager(ck)
    tree = load_tree(os.path.join(ck, mgr.newest_committed(), STATE_FILE))
    mgr.close()
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = t

    walk("", tree)
    return out


def observe_phase(dev, work_dir, card):
    """Paths 'observe_train_off', 'observe_train_step' and
    'observe_serve' (module docstring, 21) -> (summary, counts by
    path)."""
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_dataset
    from cgnn_tpu_torch.observe.export import parse_prometheus_text
    from cgnn_tpu_torch.observe.metrics_io import read_jsonl

    del dev  # the entry points run on the default card
    root = os.path.join(work_dir, "observe")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data_cfg = DataConfig()
    split = train_val_test_split(load_synthetic(
        N_TRAIN_SET, data_cfg.featurize_config(), seed=SEED), 0.8, 0.1,
        seed=SEED)
    n_conv = ModelConfig().n_conv
    per_step = dense_per_step(n_conv)
    logical = entry_logical(split, M, OBS_EPOCHS)
    base = ["--synthetic", str(N_TRAIN_SET), "--device-resident", "-b",
            str(BATCH), "--epochs", str(OBS_EPOCHS), "--cgconv-impl",
            "pallas", "--print-freq", "0", "--seed", str(SEED)]
    summary = {"card": card}
    counts, infos = {}, {}
    for level in ("off", "step"):
        path = f"observe_train_{level}"
        ck = os.path.join(root, f"{level}_ckpt")
        _, info, counts[path] = entry_train(
            path, base + ["--telemetry", level, "--ckpt-dir", ck,
                          "--out-dir", os.path.join(root, f"{level}_out")],
            per_step, logical)
        check("fallback" not in info["staging"]
              and info["graphs"]["captures"] > 0,
              f"{path}: the driver did not run: {info['staging']}")
        infos[level] = info
    # the tap and the grad-health metrics read, and write, nothing of
    # the trajectory: every tensor of the saves, and the parameter file
    off_bits = save_tree_bits(os.path.join(root, "off_ckpt"))
    step_bits = save_tree_bits(os.path.join(root, "step_ckpt"))
    check(off_bits.keys() == step_bits.keys() and all(
        np.array_equal(off_bits[k], step_bits[k]) for k in off_bits),
        "observe: the final states at --telemetry off and step differ")
    with np.load(os.path.join(root, "off_out", "params.npz")) as a, \
            np.load(os.path.join(root, "step_out", "params.npz")) as b:
        check(sorted(a.files) == sorted(b.files)
              and all(np.array_equal(a[k], b[k]) for k in a.files),
              "observe: the parameter files at off and step differ")
    check(infos["off"]["train_loss"] == infos["step"]["train_loss"]
          and infos["off"]["val_metric"] == infos["step"]["val_metric"],
          f"observe: epoch means differ: {infos['off']['train_loss']} vs "
          f"{infos['step']['train_loss']}")
    check(not os.path.exists(os.path.join(root, "off_ckpt", "logs")),
          "observe: --telemetry off wrote logs/")
    logs = os.path.join(root, "step_ckpt", "logs")
    recs = read_jsonl(os.path.join(logs, "metrics.jsonl"))
    steps = [r for r in recs if r.get("event") == "step"]
    train = sorted((r for r in steps if r["phase"] == "train"),
                   key=lambda r: r["step"])
    n_train = sum(infos["step"]["train_steps"])
    check([r["step"] for r in train] == list(range(1, n_train + 1))
          and all(np.isfinite(r["grad_norm"]) for r in train),
          f"observe: {len(train)} train records for {n_train} optimizer "
          f"steps, steps {[r['step'] for r in train][:8]}...")
    n_eval = sum(r["phase"] == "eval" for r in steps)
    check(n_eval == sum(infos["step"]["eval_steps"]),
          f"observe: {n_eval} eval records for "
          f"{infos['step']['eval_steps']} eval steps")
    run_summary = next(r for r in recs if r.get("event") == "run_summary")
    trace = json.load(open(os.path.join(logs, "trace.json")))
    names = {e["name"] for e in trace["traceEvents"]}
    check({"epoch", "checkpoint_save", "stage_scan_stacks"} <= names,
          f"observe: trace.json spans {sorted(names)}")
    manifest = json.load(open(os.path.join(logs, "manifest.json")))
    check(manifest["backend"] == "cuda" and manifest["devices"][0]["kind"]
          == torch.cuda.get_device_name(0),
          f"observe: manifest devices {manifest['devices']}")
    rates = {}
    for level, info in infos.items():
        # epochs 2 on (the first pays the captures' first replays)
        secs = sum(info["epoch_seconds"][1:])
        rates[level] = {
            "train_steps_per_s": sum(info["train_steps"][1:]) / secs,
            "train_structures_per_s": len(split[0]) * (OBS_EPOCHS - 1)
            / secs}
    stream_rates = [r["steps_per_s"] for r in train if "steps_per_s" in r]
    summary.update(
        train_rates_steady=rates,
        step_over_off=rates["step"]["train_steps_per_s"]
        / rates["off"]["train_steps_per_s"],
        stream_records={"train": len(train), "eval": n_eval},
        stream_steps_per_s_median=float(np.median(stream_rates)),
        grad_norm_last=train[-1]["grad_norm"],
        run_summary_counters=run_summary["counters"])
    print(f"observe train: {json.dumps(summary, allow_nan=False)}")

    # serving: featurized graphs and wire-form structures over HTTP
    tdir = os.path.join(root, "serve_telemetry")
    proc = ServeProcess("observe_serve", os.path.join(root, "step_ckpt"),
                        root, ("--telemetry-dir", tdir, "--live-metrics",
                               "0.5"))
    try:
        proc.wait_ready()
        fcfg = data_cfg.featurize_config()
        graphs = load_synthetic(N_OBS_HTTP, fcfg, seed=SEED + 41)
        structs = [RawStructure.from_structure(s, cif_id=sid) for sid, s, _
                   in synthetic_dataset(N_OBS_HTTP, seed=SEED + 42)]
        res, wall = http_burst(proc.port, [graph_body(g) for g in graphs]
                               + [structure_body(rs) for rs in structs])
        burst = burst_rates("observe_serve", res, wall)
        st, ctype, text = http_text(proc.port, "/metrics")
        check(st == 200 and ctype.startswith("text/plain; version=0.0.4"),
              f"observe_serve: /metrics answered {st} {ctype}")
        stats = proc.stats()
        fams = parse_prometheus_text(text)
        c = stats["counts"]
        # every serving counter (stats() adds the graph counts, which
        # are no serve_* counters)
        graph_keys = ("graph_captures", "graph_replays",
                      "captures_after_warm")
        bad = {k: (v, fams.get(f"cgnn_serve_{k}_total"))
               for k, v in c.items() if k not in graph_keys
               and [x[1] for x in fams.get(f"cgnn_serve_{k}_total",
                                           {"samples": []})["samples"]]
               != [float(v)]}
        check(not bad, f"observe_serve: /metrics counters differ from "
                       f"/stats: {bad}")
        occ = {n: f["samples"][0][1] for n, f in fams.items()
               if re.match(r"cgnn_ingest_rung\d+_edge_occupancy$", n)}
        check(occ and all(0.0 < v <= 1.0 for v in occ.values())
              and c["pack_raw"] > 0,
              f"observe_serve: edge occupancy {occ}, pack_raw "
              f"{c['pack_raw']}")
        rc = proc.stop()
    finally:
        proc.kill()
    counts["observe_serve"] = http_path(proc, rc, per_step)
    srecs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
    check(srecs and srecs[-1]["event"] == "run_summary"
          and srecs[-1]["counters"]["serve_responses"] == c["responses"],
          f"observe_serve: metrics.jsonl ends {srecs[-1:]}")
    snames = {e["name"] for e in json.load(open(os.path.join(
        tdir, "trace.json")))["traceEvents"]}
    check({"serve.request", "serve.pack", "serve.dispatch"} <= snames,
          f"observe_serve: trace.json spans {sorted(snames)}")
    check(os.path.exists(os.path.join(tdir, "metrics_live.jsonl")),
          "observe_serve: no metrics_live.jsonl")
    summary["serve"] = {"burst": burst, "edge_occupancy": occ,
                        "families": len(fams),
                        "pack_raw": c["pack_raw"],
                        "responses": c["responses"]}
    print(f"observe: {json.dumps(summary, allow_nan=False)}")
    return summary, counts


def timed(name, phase, *args):
    """``phase(*args)``, its seconds printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {name}: {time.perf_counter() - t0!r} s")
    return out


def main() -> int:
    import faulthandler

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    # a hang dumps every thread's stack and fails before the time limit
    faulthandler.dump_traceback_later(HANG_DUMP_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.rawbatch import plan_raw_spec
    from cgnn_tpu_torch.ops import _build
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.build(["fused_cgconv", "fused_epilogue", "neighbor_search",
                  "segment_sum", "windowed_gather"])
    print(f"kernel build: {time.perf_counter() - t0!r} s")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            # each function's properties line names it; then its spills
            # and registers
            if any(key in line for key in ("Function properties",
                                           "registers", "spill")):
                print(f"  {name}: {line.strip()}")
    # geometry kept: the raw wire plans its caps from the lattices
    calibration = load_synthetic_mp(64, seed=SEED, keep_geometry=True)
    fcfg = DataConfig().featurize_config()
    shape_set = plan_shape_set(
        calibration, 64, rungs=3, dense_m=M,
        raw=plan_raw_spec(calibration, fcfg.gdf(), fcfg.radius, M))
    t0 = time.perf_counter()
    split = train_val_test_split(load_synthetic_mp(N_TRAIN_SET,
                                                   seed=SEED + 3),
                                 0.8, 0.1, seed=SEED)
    print(f"featurized {N_TRAIN_SET} training structures in "
          f"{time.perf_counter() - t0!r} s")
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    kernels = [timed("kernel", kernel_phase, dev, calibration, shape_set)]
    train_entries, kernels[0]["train_shape"] = timed(
        "train_kernel", train_kernel_phase, dev, split[0])
    kernels += train_entries
    search_entry, kernels[0]["raw_top_rung"] = timed(
        "search_kernel", search_kernel_phase, dev, calibration, shape_set)
    kernels.append(search_entry)
    kernels += timed("coo_kernel", coo_kernel_phase, dev, split[0],
                     calibration)
    kernels += timed("bf16_kernel", bf16_kernel_phase, dev, split[0],
                     calibration, shape_set)
    hm_summary, hm_counts = timed("heads_modes", heads_modes_phase, dev,
                                  work_dir, card, calibration)
    bp_summary, bp_counts = timed("bf16_paths", bf16_paths_phase, dev,
                                  work_dir, card, calibration)
    summary, breakdown, raw_breakdown, by_path = timed(
        "serve", serve_phase, dev, calibration, work_dir)
    train_summary, train_counts, node_cap = timed("train", train_phase, dev,
                                                  split, work_dir)
    traj, epi_counts = timed("trajectory", trajectory_phase, dev, split[0],
                             split[1], node_cap)
    breakdowns = [train_breakdown(dev, split[0], "kernel path",
                                  cgconv_impl="pallas"),
                  train_breakdown(dev, split[0], "plain path"),
                  train_breakdown(dev, split[0], "COO kernel path",
                                  dense_m=0, aggregation=COO_AGG)]
    coo_train, coo_train_counts, coo_weights = timed(
        "train_coo", train_coo_phase, dev, split, work_dir)
    coo_serve, coo_breakdown, coo_serve_counts = timed(
        "serve_coo", serve_coo_phase, dev, calibration, coo_weights)
    # early in the process, with the other in-process traced bursts: late
    # in the long process a burst's trace has lost a kernel record
    dt_summary, dt_counts = timed(
        "serve_devices_tiers", serve_devices_tiers_phase, dev, work_dir,
        card, split, calibration, coo_weights)
    obs_summary, obs_counts = timed("observe", observe_phase, dev, work_dir,
                                    card)
    ckpt_summary, ckpt_counts = timed("checkpoint_predict",
                                      checkpoint_predict_phase, dev,
                                      work_dir, card)
    cif_summary, cif_counts, cif_breakdowns = timed(
        "cif_pipeline", cif_pipeline_phase, dev, work_dir, card, calibration)
    dl_summary, dl_counts = timed("data_layer", data_layer_phase, dev,
                                  work_dir, card)
    graphs_summary, graphs_counts, mp_split = timed(
        "step_graphs", step_graphs_phase, dev, work_dir, calibration,
        coo_weights, card)
    res_summary, res_counts = timed("resilience", resilience_phase, dev,
                                    work_dir, split, mp_split)
    dp_summary, dp_counts = timed("data_parallel", data_parallel_phase, dev,
                                  work_dir, card)
    gs_summary, gs_counts = timed("graph_shards", graph_shards_phase, dev,
                                  work_dir, card)
    dpd_summary, dpd_counts = timed(
        "dp_driver", dp_driver_phase, dev, work_dir, card,
        dp_summary["train_structures_per_s"]["two_ranks_one_card"])
    http_summary, http_counts = timed("serve_http", serve_http_phase, dev,
                                      work_dir, card)
    # last: its paths launch no kernel but oc20_train's, and an in-process
    # server burst's trace lost a kernel record when it ran before them
    force_summary, force_counts = timed("force_task", force_task_phase, dev,
                                        work_dir, card)
    # item 13's probe: the early raw tiers burst again, last
    late_summary, late_counts = timed("tiers_raw_late", tiers_raw_late_phase,
                                      dev, work_dir, calibration)
    by_path.update(**graphs_counts, **res_counts, **http_counts,
                   **hm_counts, **bp_counts, **force_counts, **dl_counts,
                   **dp_counts, **gs_counts, **dpd_counts, **dt_counts,
                   **late_counts, **obs_counts)
    by_path.update(train_cgconv_pallas=train_counts,
                   train_fused_epilogue_pallas=epi_counts,
                   train_coo=coo_train_counts, serve_coo=coo_serve_counts,
                   **ckpt_counts, **cif_counts)
    for k in kernels:
        if k["name"] in VECTOR_ROWS:
            k["ptxas"] = ptxas_usage(
                _build.build_info["fused_epilogue"]["log"], k["name"])
            check(all(not u or u["spill_stores"] == u["spill_loads"] == 0
                      for u in k["ptxas"].values()),
                  f"{k['name']} spills registers: {k['ptxas']}")
        # launches on the card in each path's run (graph replays
        # included), and those its wrapper made (eager steps, warm-ups)
        k["launches_by_path"] = {p: c["launches"][k["name"]]
                                 for p, c in by_path.items()}
        k["wrapper_launches_by_path"] = {
            p: c["wrapper_launches"][k["name"]] for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] in NO_PATH:  # no path exists: the kernel phase's
            check(k["launches"] == 0 and k["kernel_phase_launches"] > 0,
                  f"{k['name']}: {k['launches_by_path']} on paths, "
                  f"{k['kernel_phase_launches']} in the kernel phase")
            k["launches"] = k["kernel_phase_launches"]
            continue
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
    print(json.dumps({"flush_breakdown": breakdown}, allow_nan=False))
    print(json.dumps({"raw_flush_breakdown": raw_breakdown},
                     allow_nan=False))
    for b in breakdowns:
        print(json.dumps({"train_breakdown": b}, allow_nan=False))
    print(json.dumps({"train": train_summary, "trajectory": traj},
                     allow_nan=False))
    print(json.dumps({"serve": summary}, allow_nan=False))
    print(json.dumps({"coo_flush_breakdown": coo_breakdown},
                     allow_nan=False))
    print(json.dumps({"train_coo": coo_train, "serve_coo": coo_serve},
                     allow_nan=False))
    print(json.dumps({"checkpoint_predict": ckpt_summary}, allow_nan=False))
    print(json.dumps(cif_breakdowns, allow_nan=False))
    print(json.dumps({"cif_pipeline": cif_summary}, allow_nan=False))
    print(json.dumps({"data_layer": dl_summary}, allow_nan=False))
    print(json.dumps({"step_graphs": graphs_summary}, allow_nan=False))
    print(json.dumps({"resilience": res_summary}, allow_nan=False))
    print(json.dumps({"data_parallel": dp_summary}, allow_nan=False))
    print(json.dumps({"graph_shards": gs_summary}, allow_nan=False))
    print(json.dumps({"dp_driver": dpd_summary}, allow_nan=False))
    print(json.dumps({"serve_http": http_summary}, allow_nan=False))
    print(json.dumps({"serve_devices_tiers": dt_summary}, allow_nan=False))
    print(json.dumps({"tiers_raw_late": late_summary}, allow_nan=False))
    print(json.dumps({"heads_modes": hm_summary}, allow_nan=False))
    print(json.dumps({"bf16_paths": bp_summary}, allow_nan=False))
    print(json.dumps({"force_task": force_summary}, allow_nan=False))
    print(json.dumps({"observe": obs_summary}, allow_nan=False))
    print(f"chip_smoke: {time.perf_counter() - t_start!r} s in all")
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
