#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alink_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, none wrapped in ``try``; any failure or mismatch exits non-zero:

1. the card: ``nvidia-smi`` name and power limit (fails without CUDA);
2. the build of every CUDA source under ``alink_tpu_torch/kernels/csrc``
   (``nvcc``, at first use, into ``build/``), and beside it a one-thread
   probe that reads the latency of a dependent float32 and float64 add,
   sqrt, divide, exp and reciprocal off the SM's cycle counter (with the
   SM clock from ``nvidia-smi``);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in every mode (f32, f64, bf16, int8): bitwise.
   Kernel (CUDA events, median after warm-up), device (``torch.profiler``)
   and host (enqueue, host clock) times of each kernel and of its library
   call, the plain version's time and each kernel's bound; for the dense
   kernel also the chain bound (dim dependent adds at the probe's
   latency and the top SM clock). Then the dense kernel at the shapes its
   one-warp-per-row design could get wrong, bitwise in all four modes:
   n = 1, 7, 33, 512, 513 and 4096 at dim 1024, dims 8, 1031 and 65,536 at
   n = 512, the online DAG's 128-row bucket at dim 32 (phase 20), a
   request and weights off the 16-byte boundary, and signed
   zeros, infinities and NaN inside chains; and the sparse kernel at the
   shapes its warp-per-rows design could get wrong: 1, 7, 513, 4096 and
   100,000 rows, width 1031, and signed zeros, infinities and NaN inside
   chains;
4. the main path at full width: a Criteo-shape hashed LR model (39
   non-zeros per row over 2^20 features plus an intercept, random
   coefficients from ``--seed``) saved through the port's model table,
   loaded by ``LinearModelMapper`` and served by ``CompiledPredictor``
   on ``cuda`` — 4096 request rows through ``predict_table`` and 64
   single-row requests through ``PredictServer`` from 4 threads — then
   a dense 1024-wide model through ``predict_table``. Scores and labels
   must equal the same predictor on the CPU bit for bit, and each
   kernel's launch count must have moved during its path;
5. per-bucket latency (p50 of ``predict_table``) and rows/s, and the
   split of one 512-row dispatch into encode, copy in, kernel, fetch
   and decode;
6. the FTRL state kernels (gather, the gather of z and n in one launch,
   scatter-add, the chunk walk) against their plain versions on the
   card, f32 and f64, at the shapes the three update modes launch, with
   duplicate-heavy slots, a ``-0.0`` slot and padded zeros at slot 0, and
   the scatter-add also with all M positions on one slot (M = 1280 and
   4096), M = 1 and M = 4096: bitwise. The walk in both associations
   (K = 4 per-sample, K = 16 chained) on Criteo rows, rows that collide,
   rows that repeat a slot, padded rows, a ``-0.0`` z and a NaN delta;
   and the sample and chained steps on 61 rows (a micro-batch K does not
   divide) through the kernels against the same steps through the plain
   versions: bitwise (a NaN equal to any NaN). Kernel (CUDA events),
   device (``torch.profiler``), host (enqueue), plain-version and
   library-call times and each kernel's bound (the walk's also in cycles
   of the probe's latencies); the host cost of the pieces of one
   gather's issue;
7. the FTRL main path at full width: Criteo-shape one-hot rows (39
   distinct slots of 2^20 plus the intercept, ``bench.py``'s
   ``make_batch_criteo`` generator, labels from a seeded sparse true
   model) in 4096-row micro-batches. ``FtrlTrainStreamOp`` in
   ``update_mode="sample"`` warm-starts from a model table and trains
   6 micro-batches with a snapshot every 2; ``FtrlPredictStreamOp``
   scores a held-out stream with the hot-swapped snapshots; the last
   snapshot swapped into ``CompiledPredictor`` gives the same labels.
   The sample step launches 4 kernels a 4-row chunk and none a sample
   (1024 ``gather_pair``, 1024 ``ftrl_walk`` and 2048
   ``ftrl_scatter_add`` a micro-batch, no ``gather_rows``).
   Then 2 micro-batches each of ``staleness`` (K = 32) and ``chained``
   (K = 16, 256 / 256 / 512 launches a micro-batch). Every mode on the
   card in float64 agrees with the same trainer on the CPU at rtol 1e-10.
   Launch counts, samples/s per mode, the split of one micro-batch of
   each mode (encode, copy in, step, snapshot) with the card's busy share
   under the step from a profiler trace, and the progressive log loss;
8. the level-histogram kernel (``tree_hist``) against its plain version
   on the card, bitwise, at the GBDT main path's shapes (48,842 adult
   rows x 14 features, 64 bins, 3 stats, 1 to 32 nodes, and the leaf
   call), a gini shape (4 stats), 256 nodes, 488,420 rows, and shapes
   the sorted design could get wrong: every row in one slot (48,842 and
   488,420 rows), the leaf call at 488,420 rows, a last tile of one row
   (4,097 rows), a single row, columns of mostly empty bins, signed
   zero stats inside runs and 300 nodes (two key chunks). Kernel (CUDA
   events), device (the profiler's time summed over the kernel's
   passes), plain-version and ``index_add_`` times, the bytes bound, the
   scratch and the compiler's registers and shared memory;
9. the GBDT main path at full width: adult-shape rows (``bench.py``'s
   ``bench_gbdt``: 6 ``randn`` and 8 integer-code columns, its planted
   margin) through ``MemSourceBatchOp`` -> ``GbdtTrainBatchOp`` (50 trees,
   depth 6, 64 bins, learning rate 0.3) -> ``GbdtPredictBatchOp`` on the
   card. The first 5 trees equal the port's CPU run (split features,
   thresholds and masks; leaf values and loss within rtol 1e-4), two card
   trainings give bitwise equal model tables. Training AUC, samples/s,
   launch counts, the split of one tree into histogram, split search,
   descent and the rest of the superstep, the card's busy share from a
   profiler trace; then 10 trees at 488,420 rows, device binning
   included;
10. tree serving: 4096 adult rows through ``CompiledPredictor`` with the
   ``TreeModelMapper`` serving kernel, shipped in float64: scores bitwise
   equal to the host loop, labels and details equal to ``map_table``;
   rows/s and the p50 per bucket;
11. an out-of-range slot handed to the gather, the pair gather and the
   scatter-add kernel, an out-of-range key handed to the plan kernel
   (``run_plan``), and an out-of-range bin handed to the histogram
   kernel, fails its device-side assert, and the stream raises at its
   next synchronize (each in a process of its own).

12. linear training (the main path's first stage): the ordered gradient
   kernel (``linear_grad``) against its plain version (``index_add_`` on
   the CPU, the only place it keeps the order; the card's plan, built by
   ``csrc/run_plan.cu``, equal to ``run_plan_plain``'s on the CPU over
   its runs), f32 and f64, bitwise (a NaN equal to any NaN), at the
   field-blocked ``bench_logreg`` shape (200,000 rows x 33
   fields x 2048, the intercept field every row's), the same without its
   intercept column (the bulk alone), the padded-COO shape of phase 7's
   rows (100,000 x 40 over 2^20 + 1 slots), the two shapes of phase 14's
   field-blocked batch step (bench_ftrl's 4096 x 40 over 40 x 1648 and
   its stream's 16,384 x 4 over 4 x 1648, each with a run of every row)
   and at edges: every position
   on one slot, one row, slots never hit, ``-0.0``, NaN and inf terms
   inside runs, heavy runs of many lengths (one 18 times the ring, a
   tie, one at the heavy threshold and one a term short), more heavy runs
   than clusters, and heavy runs carrying NaN, +-inf and ``-0.0`` in
   the values and in c; at the five main shapes kernel (events), device
   (the span of its two launches under the profiler), host, plain (CPU)
   and ``index_add_`` times, the bytes
   bound, the chain bound of the longest run and the kernel's fraction
   of it. Then L-BFGS at ``bench_logreg``'s configuration
   (l2 1e-4, warm start ``randn * 1e-6``) through ``optimize``: ms a
   superstep (median of the untraced supersteps of a 30-superstep run at
   epsilon 0), launches a superstep by kernel and every device op of
   supersteps 5-9 under the profiler, the card's busy share under them,
   the superstep's stages (each ending in a synchronize), its host reads
   (1: the convergence bit), rows x supersteps / s, the supersteps to
   converge at epsilon 1e-6; two card runs bitwise equal; float64 on
   the card within rtol 1e-10 of the CPU on the loss curve over 10
   supersteps. Then the main path chained: 100,000 phase-7 rows through
   ``LogisticRegressionTrainBatchOp`` (padded-COO, 2^20 features) on the
   card, its model table warm-starting ``FtrlTrainStreamOp`` (2 sample
   micro-batches), the snapshot served by ``CompiledPredictor`` with
   labels equal to ``map_table``'s outside the rounding band; held-out
   AUC of both models; the gradient, margin (B5) and FTRL state (B1-B3)
   kernels' launch counts must have moved.

13. the FTRLExample loop (the reference's FTRLExample.java) end to end
   at its full width: avazu-shaped rows from ``--seed`` (its 24 columns,
   Zipf-skewed categorical values over vocabularies of avazu's order,
   clicks from a seeded logistic model; the Bayes AUC printed), 100,000
   batch rows and a 262,144-row stream in 8,192-row micro-batches, one
   event second each. The feature ``Pipeline`` (``StandardScaler`` on
   the 8 numeric columns, ``FeatureHasher`` on the 19 selected columns
   into 30,000 features) is fit, saved under ``build/`` and loaded;
   ``LogisticRegressionTrainBatchOp`` (10 supersteps, the intercept)
   warm-starts ``FtrlTrainStreamOp`` (alpha 0.1, beta 0.1, l1 0.01, l2
   0.01, a snapshot every 10 s) on one half of ``SplitStreamOp(0.5)``;
   ``FtrlPredictStreamOp`` hot-reloads its snapshots on the other half;
   ``EvalBinaryClassStreamOp`` (10 s windows) -> ``JsonValueStreamOp``
   -> ``CollectSinkStreamOp`` -> ``StreamOperator.execute()``. Two
   float32 card runs are bitwise equal (snapshots, eval JSON); the
   float64 card run is within rtol 1e-10 of the CPU's on the warm start
   and every snapshot, with equal confusion matrices and AUC within
   1e-6, on the stream's first 131,072 rows; the float32 run launches one ``linear_grad`` and two
   ``serve_sparse`` a superstep and, per micro-batch padded to the
   trainer's batch, one ``gather_pair`` and ``ftrl_walk`` and two
   ``ftrl_scatter_add`` a 4-row chunk; the last window's AUC is above
   0.6. Prints the pipeline's fit and save + load, the LR's seconds and
   supersteps, the drain's seconds and rows/s, the host-only drain
   (source -> split -> ``transform_stream`` of both halves), the
   evaluation leg alone (the other half scored by the warm start,
   evaluated, JSON values), FTRL samples/s, the trainer's stages on one
   micro-batch, the card's busy
   share under a profiled drain and every window's AUC beside the warm
   start's on the last window's rows. The host-only drain is timed bare;
   a second one, under the stage timer, reports the feature hasher's
   stages (token formatting, hashing, building the rows, the rest) and
   times the native hash against its numpy plain version on the drain's
   tokens, in turns, with the host's CPU beside them.

14. (run before 13, whose profiled drain leaves ``torch.profiler``
   recording few later kernels) FTRL's batch mode
   (``update_mode="batch"``) and dense input at
   ``bench.py::bench_ftrl``'s shapes and hyperparameters: (a) the ordered
   scatter-add (``scatter_walk``, the batch update of z and n: heavy
   clusters and light blocks, two launches on two streams) against its
   plain version on the CPU, bitwise, f32 and f64, at the padded-COO
   batch shape (4096 x 40 over 65,536 + 1 and 2^20 + 1 slots), the
   field-blocked one (4096 x 40 over 40 x 1648), the stream's (16,384 x
   4 over 3 x 1648 + 1), the field-blocked step's use of it (float32
   into zeroed states over 40 x 1648 and 3 x 1648 + 1) and edges (one
   update, every key one slot, a ``-0.0`` state where no key lands, NaN
   and inf terms); the card's plan (``run_plan``: ``csrc/run_plan.cu``'s
   radix sort and runs, no host read) equal to ``run_plan_plain``'s on
   the CPU over its runs at every case; with the kernel's times (events,
   the profiler's span of its launches, host), the plan's (events, and
   its device time), the wrapper's, the bytes and chain bounds and two
   ``index_add_`` calls in turns; ``gather_pair``
   against its plain version, bitwise, f32 and f64, at the padded-COO
   batch shape (163,840 positions over 65,536 + 1 and 2^20 + 1 slots)
   and the stream's field-blocked one (65,536 over 4 x 1648), with its
   times; (b) the padded-COO, field-blocked (with and without values),
   dense batch and dense strict steps: float64 on the card against the
   CPU over 3 micro-batches (2 for the strict one, cut to 512 rows), at
   rtol 1e-10, the field-blocked ones, float32 inside as in the JAX
   package, within 1e-6 of their largest change; two float32 runs
   bitwise; the padded-COO and field-blocked steps once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no call waits on the
   card); launches, device ops, ms and samples/s of one micro-batch and
   the card's busy share; then ``FtrlTrainStreamOp(update_mode="batch")``
   on 6 Criteo-shape micro-batches: one ``gather_pair``, one ``run_plan``
   and one ``scatter_walk`` each and nothing else; (c) bench_ftrl's stream on the
   port: 262,144 rows of site / dev / app hashed field-aware into 3 x
   1648 in 16,384-row micro-batches, warm-started by 3 L-BFGS supersteps
   on the first 4,096 rows: the stream's, the host-only and the full
   DAG's (predict, windowed eval) rows/s and last window AUC, each after
   a warm run, the field-blocked program on every micro-batch (one
   ``gather_pair``, ``run_plan`` and ``scatter_walk``, no
   ``linear_grad``), the trainer's stages on one
   micro-batch and the busy share; a stream that stops being
   field-blocked demoted exactly (the op's snapshot bitwise equal to the
   translation by hand); (d) the batch hook's pre and post calls in
   order and a device snapshot consumer that takes every hand-off of the
   live card weights, leaving no host snapshot. The host-only drain is
   timed bare, then a second one reports the hasher's stages and the
   hash in turns, as in phase 13.

15. the ingest path (after 13): (a) ``bench.py::bench_logreg_from_disk``
   on the port: 1,000,000 ``make_ctr_fieldblock`` rows (32 fields of
   2048, seed 42) written once as LibSVM under ``tempfile.gettempdir()``
   (about 253 MB, removed at the end), loaded by the port's
   ``io/fieldblock.py::load_fieldblock_libsvm``: read in 64 byte-range
   shards on ``prefetch_map``'s pool and parsed by the native
   ``parse_libsvm_fb16`` into int16 ids and float32 labels, sent to the
   card in 16 groups of pinned buffers with non-blocking copies, joined
   and widened to int32 on the card; then 3
   field-blocked L-BFGS supersteps through ``optimize``: the card's ids
   and labels bitwise equal to the generated arrays, the coefficients
   bitwise equal to those trained from the arrays in memory, P1 and B5
   launched; read_s, parse_s, copy_s, rp_wall_s, train_s, pipeline
   and in-memory samples/s and pipeline_vs_memory (medians of 3 paired
   reps), the raw read MB/s of the same sharded reads at the loader's
   width; (b) 100,000
   ``make_batch_criteo`` rows (39 one-hot slots over 65,536) written by
   ``LibSvmSinkBatchOp``, read back bitwise by ``LibSvmSourceBatchOp``,
   whose 4 sharded reads' union is the whole table, ->
   ``LogisticRegressionTrainBatchOp`` -> ``CompiledPredictor`` on 8,192
   held-out rows: the model bitwise equal to the one trained from the
   rows in a ``MemSourceBatchOp``, served labels equal to ``map_table``'s
   outside the rounding band, P1 and B5 launched. Every number beside
   the card's name and power limit and the host's CPU and core count.

16. the rest of the linear family and KMeans (after 15; TF32 off for
   every dense product): (a) ``bench.py::bench_softmax`` at its shape
   (60,000 x 784 seeded blobs plus the intercept, k = 10, l2 1e-4, warm
   start ``randn * 1e-6``) on the card once through ``optimize`` with
   ``SoftmaxObjFunc``: ms a superstep (median of the untraced
   supersteps of 30 at epsilon 0), samples/s, the superstep's stages
   (logits, gradient, direction, line search, update), its device ops
   and busy share under the profiler, supersteps to converge (epsilon
   1e-6, at most 60) and the training accuracy; two float32 runs
   bitwise; float64 on the card within rtol 1e-10 of the CPU on the loss
   curve over 10 supersteps on the first 6,000 rows; the converged model
   served by ``CompiledPredictor`` on 4,096 dense rows (B4 once a class
   column a chunk), labels equal to ``map_table``'s outside the rounding
   band; (b) ``SoftmaxTrainBatchOp`` on 100,000 Criteo-shape rows (39
   one-hot slots over 65,536, k = 4 labels from seeded sparse linear
   models and Gumbel noise): 2(k-1) B5 and (k-1) P1 launches a superstep
   and one plan, then 8,192 held-out rows served (k - 1 B5 launches a
   chunk), labels equal to ``map_table``'s outside the band; (c) on the
   same rows the linear SVM, perceptron, linear, ridge, lasso (OWLQN)
   and SVR regression train ops (20 supersteps each, B5 and P1
   launched), each served by ``CompiledPredictor`` against
   ``map_table`` (labels outside the band, or scores within it); Newton
   on bench_softmax's first 6,000 rows (class 0 against the rest, 785
   columns): float64 card within rtol 1e-10 of the CPU; SGD at
   ``mini_batch_fraction`` 0.1: two card runs bitwise; (d)
   ``bench.py::bench_kmeans`` at its shape without scikit-learn (150
   iris-shaped seeded rows tiled 10,000 times plus 0.05 noise: 1,500,000
   x 4 float32, k = 3, RANDOM init): ms a superstep of 200 at tol 0,
   samples/s and busy share, iterations to converge (tol 1e-4, at most
   500, RANDOM and K_MEANS_PARALLEL), two runs bitwise, float64 card
   centroids within rtol 1e-10 of the CPU's over 20 iterations with
   equal assignments, ``KMeansPredictBatchOp`` on the card equal to the
   CPU's (ids; squared distances within 8 eps (|x| + |c|)^2, the
   rounding of the one-product distance), and
   ``dryrun_multichip``'s KMeans leg (``KMeansTrainBatchOp(feature_cols=
   ["x0", "x1"], k=2, max_iter=3)``).

17. durability (after 16): faults armed in process
   (``common/faults.py::scoped_fault_env``); each armed site must raise
   ``FaultInjected`` and nothing else may. (a) L-BFGS at
   ``bench_logreg``'s field-blocked shape (phase 12(b)'s data, 12
   supersteps at epsilon 0): plain, then, with the async snapshot writer
   on and then off, checkpointed every 4, killed at superstep 8 (only
   ckpt-4 survives) and resumed: coefficients, loss curve and step count
   bitwise the plain run's; the two writers' snapshot array files equal;
   the resumed run's P1, B5 and ``run_plan`` launches those of 8
   supersteps of the uninterrupted run plus the plan's rebuild; ms a
   superstep with and without checkpoints, each snapshot's fetch and
   write ms and MB, the resume's load ms. (b) FTRL: ``update_mode=
   "sample"`` on 8 Criteo-shape micro-batches of 4096 at 2^20 features,
   checkpointed every 2, killed after micro-batch 5; and bench_ftrl's
   stream as phase 14 runs it, checkpointed every 4, killed after
   micro-batch 9 of 16: each final model bitwise the uninterrupted
   drain's, the resumed drains' B1-B3 or P2 / plan / gather launches
   those of the micro-batches left; each checkpoint's ms and MB (2^20 + 1
   slots) beside the JSON model snapshot's ms. (c) KMeans at
   ``bench_kmeans``' shape, 8 supersteps at tol 0, checkpointed every 2,
   killed at 4: centroids and weights bitwise. (d) one array file of
   (a)'s directory corrupted: ``validate_checkpoint`` raises and
   ``latest_checkpoint`` falls back to the older snapshot.

18. ALS, the evaluation and the stream twins (after 17; TF32 off): (a)
   ``bench.py::bench_als`` at its shape, not cut (6,040 users x 3,706
   items, 1,000,000 ratings from its ``RandomState(0)`` generator, rank
   10, lambda 0.1) through ``als_train`` on the card: ms a superstep (CUDA
   events at each superstep's end, median of 39), samples/s, peak memory,
   device ops and busy share under the profiler (supersteps 5-9), the
   stage split (gather and contributions, prefix, slots, solve, RMSE;
   host clock, each ending in a synchronize), the bound (bench.py's
   3,168 bytes a rating-iteration at 3.35 TB/s), bench.py's ``tol=1e-3``
   run (the same 10 iterations as the JAX package, its RMSE curve within
   5e-5 of the JAX package's figures), two card runs bitwise, the card
   within 1e-4 (factors, of the largest) and 1e-5 (curve) of the port on
   the CPU over 5 supersteps, and bench.py's numpy host sweep with
   vs_baseline; (b) ``bench_als_large`` at its shape (69,878 x 10,677,
   10,000,000 ratings): the same numbers over 8 timed supersteps and its
   5-iteration RMSE; (c) at (a)'s ratings through ``MemSourceBatchOp``:
   ``AlsTrainBatchOp`` -> ``AlsPredictBatchOp`` on 100,000 held-out
   pairs (about 4 % with an unknown id: NaN) equal to a numpy float64
   re-rating from the model table -> ``EvalRegressionBatchOp`` (its RMSE
   numpy's), ``AlsTopKPredictBatchOp`` for 1,000 users (numpy's top 10),
   ``AlsPredictStreamOp`` over 4096-row micro-batches equal to the batch
   op, and ``implicit_prefs`` and ``nonnegative`` 3 supersteps each on
   the card against the CPU (5e-3 and 1e-4 of the largest factor;
   nonnegative factors >= 0), and ``dryrun_multichip``'s ALS leg (15
   ratings, rank 2, 2 iterations); (d) ``LogisticRegressionPredictStreamOp``,
   ``SoftmaxPredictStreamOp``, ``GbdtPredictStreamOp`` and
   ``KMeansPredictStreamOp`` on the card with phase 9's and 16's models
   (trained again from their seeds), row for row their batch ops', then
   ``EvalMultiClassBatchOp`` on Softmax's output and
   ``EvalClusterBatchOp`` on KMeans'. ALS, its operators, the twins and
   their batch ops launch no hand kernel (the counts read 0 over (a)-(c)
   and over (d)'s predictions).

19. the serving tier at ``bench.py``'s serving shapes (after 18), each
   leg's dense LR from ``_serve_fixture``'s recipe (seeded rows, a
   4-iteration warm start on the card) served by ``CompiledPredictor``
   on the card through B4: (a) ``bench_serve_logreg`` (2,000 x 64):
   20,000 requests from 4 clients with pipeline 32 through
   ``PredictServer`` against 2,000 serial requests (``max_batch=1``),
   each warmed and timed under ``measured_region`` — qps, serial qps,
   speedup, p50 and p99, occupancy, bucket hit rate, B4's summed
   CUDA-event time as a share of the leg's wall time, and the split of
   one dispatch of 1, 8, 32 and 128 rows; (b) ``bench_serve_hot_swap``
   (6,144 x 64): 4,000 probe requests a phase before, during (8,000)
   and after the swaps of an ``update_mode="batch"`` FTRL stream on
   256-row micro-batches, once through ``ModelStreamFeeder`` and once
   through ``DeviceWeightsFeeder``; (c) ``bench_serve_chaos`` (4,096 x
   48, 3,000 requests a phase, ``ALINK_TPU_SERVE_BREAKER_MAX_MS=200``):
   ``serve.dispatch:1-14:error;feeder.snapshot:1-1:corrupt`` under the
   swap stream, probes until the breaker closes, ``serve.dispatch:1:
   delay:30`` with 6 requests of a 4 ms deadline behind it, then a
   recovery phase. Gates: on 300 rows of each leg the card's scores and
   labels equal the same predictor's on the CPU bit for bit, and its
   labels the float64 host mapper's outside the float32 rounding band;
   no failed request in (a) and (b); no torn response in (b) and (c)
   (every answer one of the versions' CPU-predictor answers, the
   versions those of the model tables the ``ModelStreamFeeder`` leg
   swapped in); the weights ``DeviceWeightsFeeder`` installs on the
   card equal those tables' bitwise, swap by swap; the swap
   count the CPU run's for the same stream, with both feeders (in (c)
   one fewer: the corrupt snapshot skipped); in (c) no silent drop,
   typed rejections, at least one breaker open, the breaker closed at
   the end and device batches after the storm; no fallback batch and no
   breaker open in (a), (b) and (c)'s clean phases; B4 launched once a
   dispatched batch in (a) and (b), and before and after the storm in
   (c).

20. the online DAG (after 19): (a)-(d) ``bench.py::
   bench_serve_online_e2e`` at its shape through ``OnlineDag`` on the
   card — the FTRLExample loop as one supervised program (ingest, FTRL
   batch mode with checkpoints every 2 micro-batches, the snapshot
   stream, hot swaps into ``PredictServer`` over B4, windowed eval, SLO
   verdicts) on ``_serve_fixture(4096, 32, seed=17)``'s rows in 128-row
   micro-batches with ``ALINK_TPU_SERVE_BREAKER_MAX_MS=200``: (a) steady
   state, throughput pacing, ``time_interval=3.0``, under ``SloContract(
   serve_p99_s=2.0, swap_staleness_s=30.0, final_window_auc=0.75)``;
   (b) the deterministic golden run on the first 2,048 rows,
   ``time_interval=2.0``, twice; (c) the trainer storm ``ftrl.batch:4-4;
   ckpt.save:2-2:error;ingest.batch:3-3;prefetch.get:1-60:delay:1`` with
   bench.py's ``clear_trainer_kill``; (d) the serve storm
   ``serve.dispatch:1-8:error;feeder.snapshot:1-1:corrupt``; then (b)
   again on the CPU (float32). Gates: (a) the SLO contract holds and the
   final-window AUC is at least 0.75; the second golden run's journals
   and (c)'s are (b)'s byte for byte, every restart of (c) typed by its
   policy with a measured recovery; (d) the breaker opens and ends
   closed, the last scored batch is (b)'s bitwise, the corrupt snapshot
   skipped, typed rejections; no silent drop in any run; no fallback
   batch, breaker open or failed request in (a)-(c); B4 launched for
   every batch the card served and no other kernel; (b) on the CPU: the
   same windows, rows and swaps, each window's AUC within
   ``E2E_AUC_TOL``, each scored probability within ``E2E_P_TOL`` and the
   labels equal outside ``E2E_LABEL_BAND``; the
   last swap's ``last_good.json`` loads in ``load_model_table`` and
   answers as the served model bit for bit. (e) health on the card:
   L-BFGS at 12(b)'s shape, KMeans at 16(d)'s and the padded-COO FTRL
   batch drain at 14's, each with a ``HealthMonitor``, bitwise the runs
   without one, the monitors' series the results' probes; the sparse
   batch step and its progressive scalars, with a monitor and without,
   under sync debug "error"; a NaN label raising
   ``HealthAlertError`` at the first checkpoint boundary with that
   snapshot on disk, which then resumes.

21. FM, LDA and Word2Vec with their text front end (after 20; TF32 off):
   (a) ``FmClassifierTrainBatchOp`` on phase 16's 100,000 Criteo-shape
   rows (39 one-hot slots of 65,536; ``num_factor`` 10, 10 epochs of 8
   mini-batches): two float32 card runs bitwise, P3 once a mini-batch on
   one plan; ``fm_train`` at one mini-batch an epoch in float64 on the
   first 20,000 rows, card within rtol 1e-10 of the CPU on ``w0``, ``w``,
   ``V`` and the loss curve; P3 (``kernels/rows.py``) bitwise to its
   plain version at the gradient's shape (3,900,000 x 12 over 65,536, f32
   and f64); P4 (``kernels/fm.py``) bitwise to its plain version at every
   bucket 1-512, sparse and dense (1,024 features), f32 and f64; the
   model served by ``CompiledPredictor`` on 8,192 held-out rows, P4 once
   a 512-row chunk, labels equal to the float64 host ``map_table``'s
   outside the rounding band; (b) LDA on a seeded corpus shaped like 20
   Newsgroups' training split (11,314 docs of Poisson(150) tokens over
   30,000 words, 20 planted topics), ``em``, ``gibbs`` and ``online``
   (sub-sampling 0.25, offset 1) at 10 iterations: two card runs bitwise
   each, P3 once a superstep on one plan (em, online), the planted topics
   recovered (``LDA_MIN_RECOVERED`` at cosine 0.9 and
   ``LDA_MIN_MEAN_COSINE``, each method's lowest reading of both packages
   on the CPU over 5 seeds: ``tools/lda_recovery.py``), Gibbs' counts
   totalling the tokens exactly; the float64
   E-step on the card within rtol 1e-10 of the CPU's from one ``gamma0``;
   ``LdaTrainBatchOp`` on the first 2,000 docs' text and
   ``LdaPredictBatchOp``'s topics on the card equal to the CPU mapper's
   away from ties; (c) Word2Vec (the op's widths: 100, window 5, batch
   256; 2 epochs) on a text8-shaped corpus (Zipf over 30,000 words,
   200,000 tokens): two float32 card runs bitwise, P3 twice a batch, P3
   bitwise at the ``in`` and ``out`` scatters' shapes, float64 card vs CPU
   within 1e-10 and float32 within ``W2V_TOL`` (the CPU test's) on the
   corpus cut to 20,000 and 2,000 tokens, device ops a batch from the
   profiler; (d) ``DocCountVectorizer`` and ``DocHashCountVectorizer`` on
   (b)'s corpus equal to counts made with numpy and the native hash, and
   ``dryrun_multichip``'s Gibbs LDA, Word2Vec and FM legs on the card.
   P3's and P4's kernel, device, host, plain and library times and bounds
   at every case. Phase 18(c) also runs the implicit case in float64, the
   card within ``ALS_IMPLICIT_F64_TOL`` of the CPU.

The line before the last is the kernels' JSON record, the one before it
the main paths' numbers; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# float32 and float64 outside the tensor cores, ops/s
PEAK_BYTES_S = 3.35e12
SPAN_SLEEP_CYCLES = 10_000_000        # about 5 ms at 1980 MHz: a queue's head start
PEAK_OPS_S = {"f32": 67e12, "f64": 34e12, "bf16": 67e12, "int8": 67e12}
DENSE_SHAPE = (512, 1024)             # the top bucket x the dense model's dim8
SPARSE_ROWS, NNZ, FEATURES = 512, 39, 1 << 20
N_REQUESTS, N_SINGLE, CLIENTS = 4096, 64, 4
MODES = (("f32", "f32"), ("f64", "f32"), ("bf16", "bf16"), ("int8", "int8"))
SRC = "alink_tpu_torch/kernels/csrc/serve_score.cu"
FTRL_SRC = "alink_tpu_torch/kernels/csrc/ftrl_state.cu"
# FTRL main path: bench.py's Criteo shape and hyperparameters
FTRL_HP = dict(alpha=0.05, beta=1.0, l1=1e-5, l2=1e-5)
FTRL_BATCH, FTRL_TRAIN_BATCHES, FTRL_HELD_BATCHES = 4096, 6, 8
FTRL_WIDTH = -(-(NNZ + 1) // 8) * 8          # 39 slots + intercept -> 40
STALE_K, CHAIN_K = 32, 16
# GBDT main path: bench.py's bench_gbdt (adult shape) and its large twin
TREE_SRC = "alink_tpu_torch/kernels/csrc/tree_hist.cu"
ADULT_N, ADULT_LARGE_N, ADULT_F = 48_842, 488_420, 14
GBDT_TREES, GBDT_DEPTH, GBDT_BINS, GBDT_LR = 50, 6, 64, 0.3
GBDT_CPU_TREES, GBDT_LARGE_TREES = 5, 10
TREE_LAUNCHES_PER_TREE = GBDT_DEPTH + 1          # the levels and the leaf call
N_SERVE = 4096
FTRL_M = {"sample": 4 * FTRL_WIDTH, "staleness": STALE_K * FTRL_WIDTH,
          "chained": CHAIN_K * FTRL_WIDTH}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bits(t):
    import torch
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _in_turns(trial, fns, trials, warm):
    """Median of ``trials`` results of ``trial(fn)`` for each of ``fns``,
    the trials of the calls taken in turns (a, b, a, b, ...), so that
    calls compared with each other see the same host, after ``warm``
    calls of each."""
    import torch
    for fn in fns:
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(trials):
        for t, fn in zip(times, fns):
            t.append(trial(fn))
    return [float(np.median(t)) for t in times]


def _event_trial(reps):
    import torch

    def trial(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps
    return trial


def _host_trial(reps):
    import torch

    def trial(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    return trial


def cuda_ms(fn, trials: int = 15, reps: int = 20, warm: int = 3) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after ``warm`` calls."""
    return _in_turns(_event_trial(reps), [fn], trials, warm)[0]


def cuda_ms_turns(*fns, trials: int = 15, reps: int = 20):
    """:func:`cuda_ms` of each of ``fns``, their trials in turns."""
    return _in_turns(_event_trial(reps), fns, trials, 3)


def device_ms(fn, part: str = "", reps: int = 20, sessions: int = 6):
    """Device time per call of the kernels whose names hold ``part``
    (every kernel and copy of the call with ``part=""``, as for a library
    call): ``torch.profiler``'s kernel times over ``reps`` back-to-back
    calls after a warm-up, summed and divided by ``reps``. Returns (ms,
    {kernel: ms}). Now and then a profiler session comes back with no
    record of a kernel launched through ctypes (about 3 % of sessions in
    one run, a few in a row at times); such a session is made again, up
    to ``sessions`` in all, and this fails if none of them saw such a
    kernel."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) or 0)
            if us > 0 and part in e.key:
                name = re.search(r"(\w+_kernel)", e.key)
                key = name.group(1) if name else e.key
                per[key] = per.get(key, 0.0) + us / reps / 1e3
        if per:
            break
        print(f"chip_smoke: profiler session {session} of {sessions} saw "
              f"no {part} kernel", file=sys.stderr)
        time.sleep(0.1)
    require(bool(per), f"the profiler saw a {part} kernel in one of "
                       f"{sessions} sessions")
    return sum(per.values()), per


def device_ms_per_launch(fn, part: str, reps: int = 20, sessions: int = 6):
    """Device time per launch of the one kernel whose name holds
    ``part``, from ``torch.profiler``: its total over ``reps`` calls
    divided by the launches the session recorded (a session can drop
    some of a ctypes kernel's records, which would make a per-call
    average too small). A session that recorded none is made again, up
    to ``sessions`` in all, as :func:`device_ms` does; this fails if none
    of them saw the kernel. Returns (ms, launches recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = 0.0, 0
        for e in prof.key_averages():
            if part in e.key:
                us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0))
                            or 0)
                seen += int(e.count)
        if seen:
            break
        print(f"chip_smoke: profiler session {session} of {sessions} saw "
              f"no {part} kernel", file=sys.stderr)
        time.sleep(0.1)
    require(seen > 0, f"the profiler saw a {part} kernel in one of "
                      f"{sessions} sessions")
    return us / seen / 1e3, seen


def device_span_ms(fn, part: str, reps: int = 20, sessions: int = 6):
    """The device time a call of ``fn`` holds the card with the kernels
    whose names hold ``part``: the union of those kernels' intervals in a
    ``torch.profiler`` trace of ``reps`` back-to-back calls, over the
    calls it saw (a call's launches overlap and count once, and a call is
    a run of overlapping launches: the gaps between calls do not count,
    and a call whose records the profiler dropped does not count either).
    The calls are queued behind a sleeping kernel
    of a few milliseconds, so the host's enqueue does not space a call's
    launches apart. A session that recorded none is made again, up to
    ``sessions`` in all, as :func:`device_ms` does; this fails if none of
    them saw the kernels. Returns (ms, launches recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    iv = []
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPAN_SLEEP_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        iv = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and part in e.name)
        if iv:
            break
        print(f"chip_smoke: profiler session {session} of {sessions} saw "
              f"no {part} kernel", file=sys.stderr)
        time.sleep(0.1)
    require(bool(iv), f"the profiler saw a {part} kernel in one of "
                      f"{sessions} sessions")
    covered, calls, lo, hi = 0.0, 1, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > hi:
            covered += hi - lo
            calls += 1
            lo, hi = a, b
        else:
            hi = max(hi, b)
    covered += hi - lo
    return covered / calls / 1e3, len(iv)


def plan_equal(kl, card, host) -> bool:
    """The card's run plan equals the plain one built on the CPU: the
    four counts, every position of ``perm``, and the first ``runs``
    entries of ``slots`` and ``order`` (``runs + 1`` of ``starts``); the
    card leaves the rest undefined."""
    import torch
    runs = kl.plan_counts(host)[0]
    return (torch.equal(card.counts.cpu(), host.counts)
            and torch.equal(card.perm.cpu(), host.perm)
            and all(torch.equal(getattr(card, f).cpu()[:runs + (f == "starts")],
                                getattr(host, f)[:runs + (f == "starts")])
                    for f in ("starts", "slots", "order")))


def host_ms_turns(*fns, trials: int = 15, reps: int = 20):
    """For each of ``fns``, the median over ``trials`` of the host clock's
    mean time of ``reps`` back-to-back calls, with no synchronize inside
    a trial (each starts on an empty queue): the cost of enqueueing one
    call. The trials of the calls are taken in turns."""
    import torch
    out = _in_turns(_host_trial(reps), fns, trials, 3)
    torch.cuda.synchronize()
    return out


def host_ms(fn, trials: int = 15, reps: int = 20) -> float:
    """:func:`host_ms_turns` of one call."""
    return host_ms_turns(fn, trials=trials, reps=reps)[0]


def host_p50_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def criteo_rows(rng, n):
    """Criteo-shape hashed rows: 13 integer fields (log-scaled counts)
    and 26 one-hot categorical fields, each hashed to a distinct slot
    of 2^20."""
    idx = np.empty((n, NNZ), np.int64)
    for i in range(n):
        idx[i] = rng.choice(FEATURES, NNZ, replace=False)
    val = np.ones((n, NNZ))
    val[:, :13] = np.log1p(rng.poisson(3.0, (n, 13)))
    return idx, val


def model_arrays(ks, w, b, mode, dev):
    if mode == "f32":
        return (w.to(dev), b.to(dev))
    if mode == "f64":
        return (w.double().to(dev), b.double().to(dev))
    return tuple(a.to(dev) for a in ks.lowp_model_arrays(w.numpy(),
                                                          b.numpy(), mode))


CHAIN_PROBE_SRC = r"""
// The latency of one dependent op on the card: one thread applies the op
// to its value n times (each op waits on the one before) between two
// reads of the SM's cycle counter. op 0: add a; 1: sqrt; 2: divide a by
// the value; 3: exp of minus the value (a negation and an exp); 4:
// reciprocal.
#include <cuda_runtime.h>
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
template <typename T, int OP>
__global__ void chain_probe(T a, int n, T* out, long long* cycles) {
  T acc = a;
  const long long t0 = clock64();
#pragma unroll 32
  for (int i = 0; i < n; ++i) {
    if (OP == 0) acc = add_rn(acc, a);
    if (OP == 1) acc = sqrt_rn(acc);
    if (OP == 2) acc = div_rn(a, acc);
    if (OP == 3) acc = exp_(-acc);
    if (OP == 4) acc = rcp_rn(acc);
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}
template <typename T>
void launch(int op, T a, int n, T* out, long long* cyc) {
  if (op == 0) chain_probe<T, 0><<<1, 1>>>(a, n, out, cyc);
  if (op == 1) chain_probe<T, 1><<<1, 1>>>(a, n, out, cyc);
  if (op == 2) chain_probe<T, 2><<<1, 1>>>(a, n, out, cyc);
  if (op == 3) chain_probe<T, 3><<<1, 1>>>(a, n, out, cyc);
  if (op == 4) chain_probe<T, 4><<<1, 1>>>(a, n, out, cyc);
}
extern "C" int op_chain_cycles(int dbl, int op, int n, long long* host_cycles) {
  void* out;
  long long* cyc;
  if (cudaMalloc(&out, 8) != cudaSuccess || cudaMalloc(&cyc, 8) != cudaSuccess) return -1;
  if (dbl) launch<double>(op, op ? 1.5 : 1e-300, n, static_cast<double*>(out), cyc);
  else launch<float>(op, op ? 1.5f : 1e-30f, n, static_cast<float*>(out), cyc);
  const int e = static_cast<int>(cudaDeviceSynchronize());
  cudaMemcpy(host_cycles, cyc, 8, cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return e;
}
"""
PROBE_OPS = ("add", "sqrt", "div", "exp", "rcp")


def start_chain_probe(build):
    """Start ``nvcc`` on the add-latency probe (beside the kernels'
    build, with their flags) into ``build/``; returns (process, library
    path)."""
    out = build.BUILD_DIR / "chain_probe.so"
    src = build.BUILD_DIR / "chain_probe.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(CHAIN_PROBE_SRC)
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def add_latency(proc, lib_path, n=1 << 16):
    """Cycles per dependent ``__fadd_rn`` and ``__dadd_rn`` (the second of
    two runs of n ops each; keys ``f32`` and ``f64``), and of the walk's
    other ops (``f32_sqrt``, ``f64_exp``, ...: sqrt, divide, a negation
    and an exp, reciprocal), and the SM clock (MHz, now and at most)."""
    import ctypes
    log, _ = proc.communicate(timeout=300)
    require(proc.returncode == 0, f"the add-latency probe built: {log}")
    lib = ctypes.CDLL(str(lib_path))
    lib.op_chain_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.op_chain_cycles.restype = ctypes.c_int
    out = {}
    for name, dbl in (("f32", 0), ("f64", 1)):
        for op, opname in enumerate(PROBE_OPS):
            cyc = ctypes.c_longlong(0)
            for _ in range(2):
                rc = lib.op_chain_cycles(dbl, op, n if op == 0 else n // 8,
                                         ctypes.addressof(cyc))
                require(rc == 0, f"the latency probe ran (CUDA error {rc})")
            key = name if op == 0 else f"{name}_{opname}"
            out[key] = cyc.value / (n if op == 0 else n // 8)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().split(",")
    out["sm_mhz"], out["max_sm_mhz"] = (float(c) for c in clocks[:2])
    return out


def chain_bound_ms(dim, mode, lat):
    """The least time of one dense row: ``dim`` dependent adds at the
    measured latency, at the SM's top clock."""
    cycles = lat["f64" if mode == "f64" else "f32"]
    return dim * cycles / (lat["max_sm_mhz"] * 1e6) * 1e3


# the dependent ops of one sample of the walk, the slot that every row
# holds (the intercept): the correction's add, the decay's add, multiply and
# add, the term, the tree's log2(width) levels, the sigmoid's add and the
# label's subtract, g, g^2, n + g^2, the sqrt difference, the multiply by
# 1 / alpha, sigma * w, the delta's subtract and the running value's add
# (add-class, 15 + the tree), then 2 sqrt, 1 divide, 1 exp, 1 reciprocal
WALK_ADDS = 15
WALK_OPS = {"sqrt": 2, "div": 1, "exp": 1, "rcp": 1}


def walk_bound_ms(K, width, kind, lat):
    """The least time of one chunk walk: K samples one after the other,
    each the chain of dependent ops above at the probe's latencies, at
    the SM's top clock."""
    levels = max(0, width - 1).bit_length()
    cycles = (WALK_ADDS + levels) * lat[kind] + sum(
        c * lat[f"{kind}_{op}"] for op, c in WALK_OPS.items())
    return K * cycles / (lat["max_sm_mhz"] * 1e6) * 1e3


def dense_inputs(rng, n, dim, kind="plain"):
    """(X float32 (n, dim), w float32 (dim,)). ``specials`` puts a row of
    -0.0, a +inf term, +inf and -inf terms (a NaN sum), a NaN value and
    -0.0 values among ordinary ones into the first rows."""
    import torch
    X = rng.standard_normal((n, dim)).astype(np.float32)
    w = (rng.standard_normal(dim) * 0.05).astype(np.float32)
    if kind == "specials":
        X[0] = -0.0
        X[1, 5] = np.inf
        X[2, 5], X[2, 9] = np.inf, -np.inf
        X[3, 100] = np.nan
        X[4, ::3] = -0.0
        X[5, -1] = -np.inf
    return torch.from_numpy(X), torch.from_numpy(w)


def misaligned(t):
    """A contiguous copy of ``t`` whose data pointer sits one element past
    a 16-byte boundary."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    require(view.is_contiguous() and view.data_ptr() % 16 != 0,
            "a contiguous view off the 16-byte boundary")
    return view


def dense_edges(ks, rng, dev):
    """The dense kernel against its plain version, bitwise, in all four
    modes, at the shapes the one-warp-per-row design could get wrong:
    n = 1, 7, 33, 512, 513 and 4096 at dim 1024; dims 8, 1031 and 65536 at
    n = 512; the online DAG's 128-row bucket at dim 32 (phase 20); a
    request and weights that start off the 16-byte boundary
    (bf16 values passed as bf16, so the kernel sees the view); signed
    zeros, infinities and NaN inside chains. Kernel and device times in
    f32 at each shape."""
    import torch
    b = torch.tensor(0.125, dtype=torch.float32)
    cases = [(f"n={n} dim=1024", n, 1024, "plain") for n in
             (1, 7, 33, 512, 513, 4096)]
    cases += [(f"n=512 dim={d}", 512, d, "plain") for d in (8, 1031, 65536)]
    # the online DAG's bucket draws from a generator of its own, so every
    # later case's and phase's inputs stay as they were
    cases += [("n=128 dim=32", 128, 32, "dag")]
    cases += [("misaligned n=512 dim=1024", 512, 1024, "misaligned"),
              ("specials n=33 dim=1024", 33, 1024, "specials")]
    out = {}
    for key, n, dim, kind in cases:
        Xh, wh = dense_inputs(np.random.default_rng(17) if kind == "dag"
                              else rng, n, dim, kind)
        rec = {}
        for mode, sdtype in MODES:
            ship = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
                mode, torch.float32) if kind == "misaligned" else (
                torch.float64 if mode == "f64" else torch.float32)
            X = Xh.to(dev, ship)
            md = model_arrays(ks, wh, b, mode, dev)
            if kind == "misaligned":
                X, md = misaligned(X), (misaligned(md[0]),) + md[1:]
            got = ks.dense_scores(md, X, sdtype)
            want = ks.dense_scores_plain(md, X, sdtype)
            torch.cuda.synchronize()
            require(torch.equal(bits(got), bits(want)),
                    f"serve_dense {key} {mode} bitwise vs its plain version "
                    f"(max abs err "
                    f"{float((got.double() - want.double()).abs().max())})")
            if kind != "specials":
                require(bool(torch.isfinite(got).all()),
                        f"serve_dense {key} {mode} finite")
            if mode == "f32":
                rec = {"kernel_ms": cuda_ms(lambda: ks.dense_scores(
                           md, X, sdtype), trials=5),
                       "device_ms": device_ms(lambda: ks.dense_scores(
                           md, X, sdtype), "serve_dense", reps=5)[0],
                       "plan": list(ks._dense_plan(n, dim, X.element_size()))}
        out[key] = dict(rec, bitwise_modes=[m for m, _ in MODES])
        print(f"serve_dense edge {key}: bitwise in {[m for m, _ in MODES]}, "
              f"f32 {rec}", flush=True)
    return out


def sparse_edges(ks, rng, dev):
    """The sparse kernel against its plain version, bitwise, in all four
    modes, at the shapes its warp-per-rows design could get wrong: one
    row, a last warp of fewer rows (7 rows of width 8), 513 and 4096 rows
    (7 rows a warp), 100,000 rows (32 rows a warp, passes that cut rows),
    width 1031 (a row over several passes), and -0.0, inf and NaN values
    inside chains. Kernel and device times in f32 at each shape."""
    import torch
    ws = torch.from_numpy((rng.standard_normal(FEATURES) * 0.05)
                          .astype(np.float32))
    b = torch.tensor(0.125, dtype=torch.float32)
    out = {}
    for n, width, kind in ((1, 40, "plain"), (7, 8, "plain"),
                           (513, 40, "plain"), (4096, 40, "plain"),
                           (100_000, 40, "plain"), (512, 1031, "plain"),
                           (33, 40, "specials")):
        key = f"n={n} width={width}" + (" specials" if kind != "plain"
                                          else "")
        idx = torch.from_numpy(rng.integers(0, FEATURES, (n, width))
                               .astype(np.int32))
        val = torch.from_numpy(rng.standard_normal((n, width))
                               .astype(np.float32))
        if kind == "specials":
            val[0] = -0.0
            val[1, 5] = np.inf
            val[2, 5], val[2, 9] = np.inf, -np.inf
            val[3, 10] = np.nan
        rec = {}
        for mode, sdtype in MODES:
            v = val.to(dev, torch.float64 if mode == "f64" else torch.float32)
            i = idx.to(dev)
            md = model_arrays(ks, ws, b, mode, dev)
            got = ks.sparse_scores(md, i, v, sdtype)
            want = ks.sparse_scores_plain(md, i, v, sdtype)
            torch.cuda.synchronize()
            require(same_bits(got, want)[1],
                    f"serve_sparse {key} {mode} bitwise vs its plain version")
            if mode == "f32":
                call = lambda: ks.sparse_scores(md, i, v, sdtype)  # noqa: E731
                rec = {"kernel_ms": cuda_ms(call, trials=5),
                       "device_ms": device_ms(call, "serve_sparse",
                                              reps=5)[0],
                       "plan": list(ks._sparse_plan(n, width))}
        out[key] = dict(rec, bitwise_modes=[m for m, _ in MODES])
        print(f"serve_sparse edge {key}: bitwise in {[m for m, _ in MODES]}, "
              f"f32 {rec}", flush=True)
    return out


def phase_kernels(ks, rng, dev, lat):
    """Each kernel against its plain version at the main path's shapes,
    then the dense kernel's edge shapes."""
    import torch
    import torch.nn.functional as F
    n, dim = DENSE_SHAPE
    Xh = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    wd = torch.from_numpy((rng.standard_normal(dim) * 0.05).astype(np.float32))
    ws = torch.from_numpy((rng.standard_normal(FEATURES) * 0.05)
                          .astype(np.float32))
    b = torch.tensor(0.125, dtype=torch.float32)
    idx0, val0 = criteo_rows(rng, SPARSE_ROWS)
    width = -(-NNZ // 8) * 8             # the encoder's width: 39 -> 40
    idx = torch.zeros((SPARSE_ROWS, width), dtype=torch.int32)
    val = torch.zeros((SPARSE_ROWS, width), dtype=torch.float32)
    idx[:, :NNZ] = torch.from_numpy(idx0)
    val[:, :NNZ] = torch.from_numpy(val0)
    out = {"serve_dense": {}, "serve_sparse": {}}
    for mode, sdtype in MODES:
        ship = torch.float64 if mode == "f64" else torch.float32
        X, v, i = Xh.to(dev, ship), val.to(dev, ship), idx.to(dev)
        md = model_arrays(ks, wd, b, mode, dev)
        msp = model_arrays(ks, ws, b, mode, dev)
        for name, kern, plain, args in (
                ("serve_dense", ks.dense_scores, ks.dense_scores_plain,
                 (md, X, sdtype)),
                ("serve_sparse", ks.sparse_scores, ks.sparse_scores_plain,
                 (msp, i, v, sdtype))):
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            same = bool(torch.equal(bits(got), bits(want)))
            err = float((got.double() - want.double()).abs().max())
            require(bool(torch.isfinite(got).all()), f"{name} {mode} finite")
            require(same, f"{name} {mode} bitwise vs its plain version "
                          f"(max abs err {err})")
            call = lambda: kern(*args)                        # noqa: E731
            rec = {"bitwise": same, "max_abs_err": err,
                   "device_ms": device_ms(call, name)[0]}
            size = X.element_size()
            if name == "serve_dense":
                wsize = md[0].element_size()
                nbytes = X.numel() * size + dim * wsize + 4 + n * 4
                ops = 2 * X.numel()
                rec["chain_bound_ms"] = chain_bound_ms(dim, mode, lat)
            else:
                wsize = msp[0].element_size()
                touched = int(torch.unique(i).numel())
                nbytes = i.numel() * 4 + v.numel() * size + touched * wsize \
                    + 4 + SPARSE_ROWS * 4
                ops = 2 * v.numel()
            rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, mode)
            rec["bytes"] = nbytes
            if mode != "f32":
                rec["kernel_ms"], rec["host_ms"] = cuda_ms(call), host_ms(call)
            else:
                rec["plain_ms"] = cuda_ms(lambda: plain(*args), trials=5,
                                          reps=2)
                if name == "serve_dense":
                    lib = lambda: torch.mv(X, md[0])             # noqa: E731
                else:
                    wcol = msp[0][:, None]
                    lib = lambda: F.embedding_bag(                # noqa: E731
                        i, wcol, per_sample_weights=v, mode="sum")
                rec["kernel_ms"], rec["library_ms"] = cuda_ms_turns(call, lib)
                rec["library_device_ms"], rec["library_kernels"] = \
                    device_ms(lib)
                rec["host_ms"], rec["library_host_ms"] = host_ms_turns(call,
                                                                       lib)
            out[name][mode] = rec
    out["serve_dense_edges"] = dense_edges(ks, rng, dev)
    out["serve_sparse_edges"] = sparse_edges(ks, rng, dev)
    return out


def build_mapper(coef, dim):
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import LinearModelMapper
    from alink_tpu_torch.common.types import TableSchema
    model = linear_model_from_numpy(coef, has_intercept=True,
                                    label_values=[1, 0], vector_col="vec",
                                    vector_size=dim, label_type="LONG")
    table = LinearModelDataConverter("LONG").save_model(model)
    mapper = LinearModelMapper(
        table.schema, TableSchema(["vec"], ["VECTOR"]),
        Params({"prediction_col": "pred", "vector_col": "vec"}))
    mapper.load_model(table)
    return mapper


def check_path(ks, kernel, mapper, req, host_terms):
    """predict_table on the card with the launch count reset around it,
    then its parity checks. Returns (launches, card predictor, its
    output table, seconds of the predict_table call)."""
    from alink_tpu_torch.serving import CompiledPredictor
    gpu, cpu = CompiledPredictor(mapper), CompiledPredictor(mapper,
                                                            device="cpu")
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    out = gpu.predict_table(req)
    secs = time.perf_counter() - t0
    launches = ks.launch_counts()[kernel]
    require(launches > 0, f"{kernel} never launched on the main path")
    require(out.num_rows == req.num_rows, "row count")
    s_gpu, s_cpu = gpu.predict_scores(req), cpu.predict_scores(req)
    require(s_gpu.dtype == np.float32 and s_gpu.shape == (req.num_rows,),
            "score dtype/shape")
    require(bool(np.isfinite(s_gpu).all()), "finite scores")
    require(np.array_equal(s_gpu.view(np.int32), s_cpu.view(np.int32)),
            "card scores bitwise equal to the CPU path")
    labels_gpu = [str(v) for v in out.col("pred")]
    labels_cpu = [str(v) for v in cpu.predict_table(req).col("pred")]
    require(labels_gpu == labels_cpu, "card labels equal to the CPU path")
    # the float64 host mapper: scores within float32 rounding of the
    # terms, labels equal wherever a score is clear of that band
    s_host = mapper.predict_scores(req)
    tol = 64 * 2.0 ** -24 * host_terms
    require(bool((np.abs(s_gpu - s_host) <= tol).all()),
            "scores within float32 rounding of the float64 host mapper")
    host_labels = [str(v) for v in mapper.map_table(req).col("pred")]
    clear = np.abs(s_host) > tol
    require(all(a == b for a, b, c in zip(labels_gpu, host_labels, clear)
                if c), "labels equal to the host mapper")
    return launches, gpu, out, secs


def bucket_latency(pred, req):
    """p50 of ``predict_table`` at each bucket's row count, and rows/s."""
    rows = {}
    for b in pred.buckets:
        sub = req.first_n(b)
        p50 = host_p50_ms(lambda: pred.predict_table(sub), reps=30)
        rows[b] = {"p50_ms": p50, "rows_per_s": b / p50 * 1e3}
    return rows


def dispatch_breakdown(pred, req, reps=30, rows=None):
    """Where one ``predict_table`` dispatch of ``rows`` rows (default:
    the top bucket) spends its time: the median host-clock time of each
    stage, each ending in a synchronize, and the kernel's share of the
    sum (the card is idle for the rest)."""
    import torch
    ver = pred._active                   # the predictor's active model
    sub = req.first_n(pred.buckets[-1] if rows is None else rows)
    n = sub.num_rows
    stages = {k: [] for k in ("encode", "to_device", "kernel", "fetch",
                              "decode")}
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        kind, tensors = ver.kernel.encode(sub, pred.bucket_for(n))
        t1 = time.perf_counter()
        placed = tuple(t.to(pred.device) for t in tensors)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = ver.kernel.device_fns[kind](ver.arrays, *placed)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = out.cpu().numpy()[:n]
        t4 = time.perf_counter()
        ver.kernel.decode((host,), sub)
        t5 = time.perf_counter()
        for k, a, z in (("encode", t0, t1), ("to_device", t1, t2),
                        ("kernel", t2, t3), ("fetch", t3, t4),
                        ("decode", t4, t5)):
            stages[k].append((z - a) * 1e3)
    med = {k: float(np.median(v[1:])) for k, v in stages.items()}
    med["kernel_share"] = med["kernel"] / sum(med.values())
    return med


# ---------------------------------------------------------------------------
# FTRL: the state kernels and the online training path
# ---------------------------------------------------------------------------

def ftrl_kernel_inputs(rng, dtype, C, M, dev, one_slot=False):
    """A (2^20 + 1, C) state with a -0.0 at slot 7 that no index names,
    and M duplicate-heavy slot indices (a pool of 48 slots, a quarter of
    the positions padded to slot 0 with zero updates); with ``one_slot``,
    all M positions name one slot (one chain of M adds)."""
    import torch
    S = FEATURES + 1
    st = torch.from_numpy(rng.standard_normal((S, C))).to(dev, dtype)
    st[7] = -0.0
    pool = rng.choice(np.arange(8, S), 48, replace=False)
    ix = pool[rng.integers(0, 48, M)]
    pad = rng.random(M) < 0.25
    ix[pad] = 0
    upd = rng.standard_normal((M, C))
    upd[pad] = 0.0
    if one_slot:
        ix[:] = pool[0]
        upd = rng.standard_normal((M, C))
    if C == 1:
        st = st[:, 0].contiguous()
        upd = upd[:, 0]
    return (st, torch.from_numpy(ix.astype(np.int32)).to(dev),
            torch.from_numpy(upd).to(dev, dtype))


WALK_CASES = ("criteo", "collisions", "repeats", "padded", "negzero", "nan")
# chunks (K, w) beyond the steps' own, each walked in both associations on
# Criteo-like rows and on rows that repeat slots: every register form of
# the narrow walk (R = 1, 4, 8 positions a lane), its largest chunk in
# shared memory (K * w = 2048, 180 KB in f64), a chunk of chunk_size 64 at
# the Criteo width (spilled to global memory in f64), and the wide walk
# in shared memory (w = 300) and spilled, at the scatter-add's limit of
# 11264 positions for either association's K
WALK_EDGES = ((4, 8), (4, 100), (4, 256), (8, 256), (64, 40), (4, 300),
              (4, 2816), (16, 704))


def walk_inputs(rng, case, K, dtype, dev, w=FTRL_WIDTH):
    """One chunk of K Criteo-shape rows of width w (40) for the walk: slot
    0 (the intercept, value 1) and w - 1 distinct slots of 2^20 (13
    log-scaled counts, the rest ones), labels from the seed, and the
    chunk's gathered state (z and n of each distinct slot, the same for
    every occurrence). The edges: ``collisions``, rows drawing from 60
    slots (as ``dup_rows``); ``repeats``, rows drawing from max(30, w / 2)
    slots with replacement (slots repeated within a row); ``padded``, the
    last 10 positions of each row at slot 0 with value 0 (as the step
    pads); ``negzero``, a z of -0.0 at the intercept and at one other
    slot; ``nan``, a NaN value in sample 1, whose deltas are then NaN (in
    the chained association they reach every later sample's correction
    as 0 * NaN)."""
    import torch
    xi = np.empty((K, w), np.int64)
    for k in range(K):
        xi[k, 1:] = rng.choice(np.arange(1, FEATURES + 1), w - 1,
                               replace=False)
    if case == "collisions":
        xi[:, 1:] = np.stack([rng.choice(np.arange(1, 61), w - 1,
                                         replace=False) for _ in range(K)])
    elif case == "repeats":
        xi[:, 1:] = rng.integers(1, max(31, w // 2 + 1), (K, w - 1))
    xi[:, 0] = 0
    xv = np.ones((K, w))
    counts = min(13, w - 1)
    xv[:, 1:1 + counts] = np.log1p(rng.poisson(3.0, (K, counts)))
    if case == "padded":
        xi[:, -10:] = 0
        xv[:, -10:] = 0.0
    if case == "nan":
        xv[1, 5] = np.nan
    uniq, inv = np.unique(xi.reshape(-1), return_inverse=True)
    st = np.stack([rng.standard_normal(len(uniq)) * 0.1,
                   np.abs(rng.standard_normal(len(uniq))) * 0.1], -1)
    if case == "negzero":
        st[0, 0] = -0.0
        st[len(uniq) // 2, 0] = -0.0
    y = (rng.random(K) < 0.5).astype(np.float64)
    return (torch.from_numpy(xi.astype(np.int32)).to(dev),
            torch.from_numpy(xv).to(dev, dtype),
            torch.from_numpy(y).to(dev, dtype),
            torch.from_numpy(st[inv]).to(dev, dtype).contiguous())


def same_bits(a, b):
    """Bitwise equal, a NaN equal to any NaN (a NaN's payload is the
    hardware's); returns (equal, raw bits equal too)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    same = bool(torch.equal(na, nb)) and bool(
        torch.equal(bits(a[~na]), bits(b[~nb])))
    return same, same and bool(torch.equal(bits(a), bits(b)))


def walk_case(kf, args, chained, key, kind, lat, timed, any_nan=False):
    """The walk kernel against its plain version on one chunk: deltas and
    margins (written at row 1 of a buffer of K + 2) bitwise, raw bits
    (NaN payloads too) unless ``any_nan`` lets a NaN equal any NaN; with
    ``timed``, its times beside its bounds (``"device"``: the device time
    alone)."""
    import torch
    xi, xv, yy, zn = args
    K, w = xi.shape
    m1 = xv.new_full((K + 2,), 9.0)
    m2 = m1.clone()
    got = kf.walk_chunk(xi, xv, yy, zn, m1, 1, **FTRL_HP, chained=chained)
    want = kf.walk_chunk_plain(xi, xv, yy, zn, m2, 1, **FTRL_HP,
                               chained=chained)
    torch.cuda.synchronize()
    same_d, raw_d = same_bits(got, want)
    same_m, raw_m = same_bits(m1, m2)
    fin = torch.isfinite(want)
    err = float((got[fin].double() - want[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    require(same_d and same_m and (any_nan or (raw_d and raw_m)),
            f"ftrl_walk {key} bitwise vs its plain version (max abs err "
            f"{err}; NaN equal to any NaN {same_d and same_m}; margins "
            f"{m1.tolist()[:8]} vs {m2.tolist()[:8]})")
    require(float(m1[0]) == 9.0 and float(m1[-1]) == 9.0,
            f"ftrl_walk {key} wrote only its chunk's margins")
    rec = {"bitwise": True, "raw_bits_equal": raw_d and raw_m,
           "nan": bool(torch.isnan(got).any()), "max_abs_err": err}
    call = lambda: kf.walk_chunk(xi, xv, yy, zn, m1, 1,     # noqa: E731
                                 **FTRL_HP, chained=chained)
    if timed == "device":
        rec["device_ms"] = device_ms(call, "ftrl_walk")[0]
        rec["chain_bound_ms"] = walk_bound_ms(K, w, kind, lat)
    if timed is not True:
        return rec
    size = xv.element_size()
    P = K * w
    nbytes = 4 * P + size * (P + K + 2 * P + K + 2 * P)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 30 * P, kind)
    rec["chain_bound_ms"] = walk_bound_ms(K, w, kind, lat)
    rec.update(kernel_ms=cuda_ms(call), device_ms=device_ms(call,
                                                            "ftrl_walk")[0],
               host_ms=host_ms(call),
               plain_ms=cuda_ms(lambda: kf.walk_chunk_plain(
                   xi, xv, yy, zn, m2, 1, **FTRL_HP, chained=chained),
                   trials=3, reps=1),
               library_ms=None)
    return rec


def walk_steps(kf, rng, dev):
    """The sample and chained steps on micro-batches that K does not
    divide (a -0.0 z at the intercept) through the kernels, against the
    same steps through the plain versions on the card: z, n and the
    margins bitwise, raw bits. 61 Criteo-shape rows drawing from 2000
    slots (so chunks collide), chained also at chunk_size 64 (2560
    positions a chunk, spilled to global memory in f64); and 13 rows of
    width 300 (the wide walk: in shared memory at K = 4, spilled at
    K = 16)."""
    import torch
    from alink_tpu_torch.operator.stream.onlinelearning import ftrl as op
    S = FEATURES + 1
    z0 = rng.standard_normal(S) * 0.1
    z0[0] = -0.0
    n0 = np.abs(rng.standard_normal(S)) * 0.1
    kernels = (op.gather_pair, op.walk_chunk, op.scatter_add_rows)
    plains = (kf.gather_pair_plain, kf.walk_chunk_plain,
              kf.scatter_add_rows_plain)
    out = {}
    for B, w, chains in ((61, FTRL_WIDTH, (CHAIN_K, 64)), (13, 300,
                                                          (CHAIN_K,))):
        xi = np.zeros((B, w), np.int32)
        for i in range(B):
            xi[i, 1:] = rng.choice(np.arange(1, 2001), w - 1, replace=False)
        xv = np.ones((B, w))
        xv[:, 1:14] = np.log1p(rng.poisson(3.0, (B, 13)))
        y = (rng.random(B) < 0.5).astype(np.float64)
        out.update(_steps_bitwise(op, kernels, plains, dev, xi, xv, y, z0,
                                  n0, chains))
    return out


def _steps_bitwise(op, kernels, plains, dev, xi, xv, y, z0, n0, chains):
    import torch
    B, w = xi.shape
    out = {}
    steps = [("sample", op.ftrl_sample_step, {})] + [
        (f"chained K={K}", op.ftrl_chained_step, {"K": K}) for K in chains]
    for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
        for name, step, kw in steps:
            args = [torch.from_numpy(xi).to(dev),
                    torch.from_numpy(xv).to(dev, dtype),
                    torch.from_numpy(y).to(dev, dtype)]
            runs = []
            for fns in (kernels, plains):
                op.gather_pair, op.walk_chunk, op.scatter_add_rows = fns
                try:
                    z = torch.tensor(z0, dtype=dtype, device=dev)
                    n = torch.tensor(n0, dtype=dtype, device=dev)
                    runs.append(step(*args, z, n, **FTRL_HP, **kw))
                    torch.cuda.synchronize()
                finally:
                    op.gather_pair, op.walk_chunk, op.scatter_add_rows = \
                        kernels
            for label, a, b in zip(("z", "n", "margins"), *runs):
                require(a.shape == b.shape and torch.equal(bits(a), bits(b)),
                        f"the {name} step on {B} rows of width {w}, {kind}: "
                        f"{label} through the kernels bitwise vs the plain "
                        f"versions")
            out[f"{kind} {name} B={B} w={w}"] = "bitwise"
    return out


def _bound(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pair_shape(kf, st, ix, kind, size, touched):
    """``gather_pair`` of the two columns of ``st`` (as the sample and
    chained steps hold z and n) against its plain version, bitwise; its
    times beside the library's two ``index_select`` calls and a stack
    (device time per launch the profiler recorded)."""
    import torch
    z, n = st[:, 0].contiguous(), st[:, 1].contiguous()
    got = kf.gather_pair(z, n, ix)
    want = kf.gather_pair_plain(z, n, ix)
    torch.cuda.synchronize()
    require(torch.equal(bits(got), bits(want)),
            f"ftrl_gather_pair {kind} M={ix.shape[0]} bitwise vs its plain "
            f"version")
    require(torch.equal(bits(got), bits(kf.gather_rows(st, ix))),
            "gather_pair equals gather_rows of the stacked state")
    M = ix.shape[0]
    b_ms, b_by = _bound(M * 4 + 2 * touched * size + 2 * M * size, 0, kind)
    lib = lambda: torch.stack([torch.index_select(z, 0, ix),   # noqa: E731
                               torch.index_select(n, 0, ix)], -1)
    call = lambda: kf.gather_pair(z, n, ix)                   # noqa: E731
    k_ms, l_ms = cuda_ms_turns(call, lib)
    k_host, l_host = host_ms_turns(call, lib)
    dev_ms, dev_seen = device_ms_per_launch(call, "ftrl_gather_kernel")
    return {"bitwise": True, "max_abs_err": 0.0, "kernel_ms": k_ms,
            "device_ms": dev_ms, "device_launches_recorded": dev_seen,
            "host_ms": k_host,
            "plain_ms": cuda_ms(lambda: kf.gather_pair_plain(z, n, ix)),
            "library_ms": l_ms, "library_device_ms": device_ms(lib)[0],
            "library_host_ms": l_host, "bound_ms": b_ms, "bound_by": b_by}


def scatter_shape(kf, key, st, ix, upd, kind, size):
    """The scatter-add kernel against its plain version at one shape,
    bitwise, the untouched -0.0 slot kept; its times and bound."""
    import torch
    M = ix.shape[0]
    C = 1 if st.dim() == 1 else st.shape[1]
    a, b = st.clone(), st.clone()
    kf.scatter_add_rows(a, ix, upd)
    kf.scatter_add_rows_plain(b, ix, upd)
    torch.cuda.synchronize()
    err = float((a.double() - b.double()).abs().max())
    require(torch.equal(bits(a), bits(b)),
            f"ftrl_scatter_add {key} bitwise vs its plain version (max abs "
            f"err {err})")
    neg = a[7] if C == 1 else a[7, 0]
    require(bool(torch.signbit(neg)) and float(neg) == 0.0,
            f"ftrl_scatter_add {key}: the untouched -0.0 slot kept its bits")
    touched = int(torch.unique(ix).numel())
    scratch = st.clone()
    b_ms, b_by = _bound(M * 4 + M * C * size + 2 * touched * C * size,
                        M * C, kind)
    return {
        "bitwise": True, "max_abs_err": err,
        "kernel_ms": cuda_ms(lambda: kf.scatter_add_rows(scratch, ix, upd)),
        "device_ms": device_ms(
            lambda: kf.scatter_add_rows(scratch, ix, upd), "ftrl_scatter")[0],
        "plain_ms": cuda_ms(
            lambda: kf.scatter_add_rows_plain(scratch, ix, upd),
            trials=3 if M > 1024 else 5, reps=1 if M > 1024 else 2),
        # not deterministic: timed as the yardstick only
        "library_ms": cuda_ms(lambda: scratch.index_add_(0, ix, upd)),
        "bound_ms": b_ms, "bound_by": b_by}


def gather_host_parts(kf, st, ix):
    """Host clock of the pieces of one gather's issue (f32 state, C = 1),
    back to back: the whole wrapper and ``index_select``; each lookup the
    earlier wrapper made (the stream object, the current device through
    ``torch.cuda``, the launch count's lock, ``torch.empty``) beside the
    one that replaces it; and the bare ctypes call."""
    import threading
    import torch
    from alink_tpu_torch.kernels import _build
    fn = kf._functions()["alink_ftrl_gather"]
    M, S = ix.shape[0], st.shape[0]
    out = torch.empty(M, dtype=st.dtype, device=st.device)
    args = (0, st.data_ptr(), ix.data_ptr(), out.data_ptr(), M, S, 1,
            _build.stream_handle(0))
    lock, counts = threading.Lock(), {"n": 0}

    def locked():
        with lock:
            counts["n"] += 1
    parts = {
        "gather_rows": lambda: kf.gather_rows(st, ix),
        "index_select": lambda: torch.index_select(st, 0, ix),
        "current_stream_object": lambda: torch.cuda.current_stream(
            st.device).cuda_stream,
        "raw_stream_handle": lambda: _build.stream_handle(0),
        "torch_cuda_current_device": torch.cuda.current_device,
        "raw_current_device": _build.current_device,
        "count_with_lock": locked,
        "count_without_lock": lambda: counts.__setitem__("n", counts["n"] + 1),
        "torch_empty_output": lambda: torch.empty(M, dtype=st.dtype,
                                                  device=st.device),
        "new_empty_output": lambda: st.new_empty(M),
        "ctypes_call": lambda: fn(*args)}
    names = list(parts)
    return dict(zip(names, host_ms_turns(*parts.values(), reps=200)))


def phase_ftrl_kernels(kf, rng, dev, lat):
    """Each FTRL kernel against its plain version on the card, bitwise,
    at every shape the three modes launch; times at each shape."""
    import torch
    rec = {"ftrl_gather": {}, "ftrl_gather_pair": {}, "ftrl_scatter_add": {},
           "ftrl_walk": {}}
    for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
        size = 4 if kind == "f32" else 8
        for mode, M in FTRL_M.items():
            for C in (1, 2):
                st, ix, upd = ftrl_kernel_inputs(rng, dtype, C, M, dev)
                key = f"{kind} {mode} M={M} C={C}"
                touched = int(torch.unique(ix).numel())
                # gather
                got = kf.gather_rows(st, ix)
                want = kf.gather_rows_plain(st, ix)
                torch.cuda.synchronize()
                require(torch.equal(bits(got), bits(want)),
                        f"ftrl_gather {key} bitwise vs its plain version")
                b_ms, b_by = _bound(M * 4 + touched * C * size
                                    + M * C * size, 0, kind)
                lib = lambda: torch.index_select(st, 0, ix)   # noqa: E731
                call = lambda: kf.gather_rows(st, ix)         # noqa: E731
                k_ms, l_ms = cuda_ms_turns(call, lib)
                k_host, l_host = host_ms_turns(call, lib)
                rec["ftrl_gather"][key] = {
                    "bitwise": True, "max_abs_err": 0.0,
                    "kernel_ms": k_ms,
                    "device_ms": device_ms(call, "ftrl_gather")[0],
                    "host_ms": k_host,
                    "plain_ms": cuda_ms(lambda: kf.gather_rows_plain(st, ix)),
                    "library_ms": l_ms,
                    "library_device_ms": device_ms(lib)[0],
                    "library_host_ms": l_host,
                    "bound_ms": b_ms, "bound_by": b_by}
                if C == 2 and mode in ("sample", "chained"):
                    rec["ftrl_gather_pair"][f"{kind} {mode} M={M}"] = \
                        pair_shape(kf, st, ix, kind, size, touched)
                rec["ftrl_scatter_add"][key] = scatter_shape(
                    kf, key, st, ix, upd, kind, size)
        # beyond the main path: all positions on one slot (one chain of
        # M), a single update, and a scatter whose sort needs the
        # shared-memory opt-in above 48 KB (4096 positions)
        for M, one in ((1280, True), (4096, True), (1, False),
                       (4096, False)):
            for C in (1, 2):
                st, ix, upd = ftrl_kernel_inputs(rng, dtype, C, M, dev,
                                                 one_slot=one)
                key = f"{kind} {'one slot' if one else 'mixed'} M={M} C={C}"
                rec["ftrl_scatter_add"][key] = scatter_shape(
                    kf, key, st, ix, upd, kind, size)
        # the walk in both associations, at the steps' K, on every edge;
        # raw bits everywhere but the chained NaN chunk in f64, where the
        # kernel's 0 * NaN is its own NaN and the plain version's carries
        # the delta's payload
        for chained, K in ((False, 4), (True, CHAIN_K)):
            assoc = "chained" if chained else "sample"
            for case in WALK_CASES:
                key = f"{kind} {assoc} K={K} w={FTRL_WIDTH} {case}"
                rec["ftrl_walk"][key] = walk_case(
                    kf, walk_inputs(rng, case, K, dtype, dev), chained, key,
                    kind, lat, timed=case == "criteo",
                    any_nan=chained and kind == "f64" and case == "nan")
            for K, w in WALK_EDGES:
                for case in ("criteo", "repeats"):
                    key = f"{kind} {assoc} K={K} w={w} {case}"
                    rec["ftrl_walk"][key] = walk_case(
                        kf, walk_inputs(rng, case, K, dtype, dev, w),
                        chained, key, kind, lat,
                        timed="device" if case == "criteo" else False)
    st, ix, _ = ftrl_kernel_inputs(rng, torch.float32, 1, FTRL_M["sample"],
                                   dev)
    rec["gather_host_parts_ms"] = gather_host_parts(kf, st, ix)
    rec["walk_steps"] = walk_steps(kf, rng, dev)
    return rec


def criteo_ftrl_rows(seed, n):
    """bench.py's ``make_batch_criteo`` rows at 2^20 features, as the
    trainer's input: 39 distinct one-hot slots per row (the trainer adds
    the intercept), labels drawn from the logistic of a seeded sparse
    true model (2 % of the features non-zero)."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    r = np.random.RandomState(seed)
    rngw = np.random.RandomState(0)
    w_true = rngw.randn(FEATURES) * (rngw.rand(FEATURES) < 0.02)
    raw = r.randint(0, FEATURES, size=(n, NNZ))
    for _ in range(64):                       # resample intra-row collisions
        srt = np.sort(raw, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        if not dup.any():
            break
        raw[dup] = r.randint(0, FEATURES, size=(int(dup.sum()), NNZ))
    raw = np.sort(raw, axis=1)
    y = (r.rand(n) < 1.0 / (1.0 + np.exp(-w_true[raw].sum(1)))).astype(
        np.int64)
    vecs = np.empty(n, object)
    ones = np.ones(NNZ)
    vecs[:] = [SparseVector(FEATURES, raw[i], ones) for i in range(n)]
    return MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


def ftrl_warm_model(rng):
    """The warm-start model table: small random coefficients from the
    seed, positive label 1."""
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    coef = rng.standard_normal(FEATURES + 1) * 0.01
    model = linear_model_from_numpy(coef, has_intercept=True,
                                    label_values=[1, 0], vector_col="vec",
                                    vector_size=FEATURES, label_type="LONG")
    return MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        model))


def ftrl_op(warm, mode, **kw):
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlTrainStreamOp
    return FtrlTrainStreamOp(warm, vector_col="vec", label_col="label",
                             update_mode=mode, staleness=STALE_K,
                             chunk_size=CHAIN_K, **FTRL_HP, **kw)


def drain_timed(op):
    """All (time, snapshot) of one drain, host clock; the snapshots'
    fetches synchronize the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = list(op.timed_batches())
    torch.cuda.synchronize()
    return snaps, time.perf_counter() - t0


def ftrl_card_vs_cpu(warm, train):
    """Each mode over 2 micro-batches, float64, on the card and on the
    CPU from the same encoded stream: z, n and every margin agree at
    rtol 1e-10 (CUDA's exp and sum orders are not the CPU's)."""
    import torch
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    out = {}
    for mode in ("sample", "staleness", "chained"):
        runs = {}
        for dev in ("cuda", "cpu"):
            op = ftrl_op(warm, mode, device=dev, ship_dtype=torch.float64)
            op.link_from(MemSourceStreamOp(train, batch_size=FTRL_BATCH))
            tr = op.trainer
            z, n = tr.initial_state()
            margins = []
            width = 8
            for b in range(2):
                mt = train.take_rows(np.arange(b * FTRL_BATCH,
                                               (b + 1) * FTRL_BATCH))
                enc = tr.encode(mt, FTRL_BATCH, width)
                width = enc.width
                z, n, mg = tr.step(tr.to_device(enc), z, n)
                margins.append(mg.cpu().numpy())
            runs[dev] = (z.cpu().numpy(), n.cpu().numpy(),
                         np.concatenate(margins))
        errs = {}
        for name, a, b in zip(("z", "n", "margins"), runs["cuda"],
                              runs["cpu"]):
            require(bool(np.isfinite(a).all()), f"{mode} {name} finite")
            gap = np.abs(a - b)
            require(bool((gap <= 1e-10 * np.abs(b) + 1e-12).all()),
                    f"ftrl {mode}: card {name} within rtol 1e-10 of the "
                    f"CPU (max abs err {gap.max()})")
            errs[name] = {"max_abs_err": float(gap.max()),
                          "max_rel_err": float(
                              (gap / np.maximum(np.abs(b), 1e-300)).max()),
                          "bitwise_share": float((a == b).mean())}
        out[mode] = errs
    return out


def trainer_stages(tr, mt, reps, allow_fb=False):
    """One micro-batch ``mt`` through the FTRL trainer ``tr``'s stages,
    encode, copy in, step and snapshot (host clock, each ending in a
    synchronize), ``reps`` times from the warm start on (``allow_fb``:
    the field-blocked encoding and layout where the rows are field-aware
    hashed): the median ms of each, with the step's samples/s; and the
    last step's device inputs and state."""
    import torch
    b = mt.num_rows
    stages = {k: [] for k in ("encode", "to_device", "step", "snapshot")}
    z = n = fb_S = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = tr.encode(mt, b, allow_fb=allow_fb)
        t1 = time.perf_counter()
        dev = tr.to_device(enc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if z is None:
            z, n = tr.initial_state(enc)
            fb_S = enc.meta.field_size if enc.kind == "fb" else None
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        z, n, _ = tr.step(dev, z, n)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.snapshot(z, n, fb_S)
        t4 = time.perf_counter()
        for k, a, e in (("encode", t0, t1), ("to_device", t1, t2),
                        ("step", t2, t3), ("snapshot", t3, t4)):
            stages[k].append((e - a) * 1e3)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    med["step_samples_per_s"] = b / med["step"] * 1e3
    return med, dev, z, n


def ftrl_split(warm, train, mode, reps=3, trace=False):
    """One 4096-row micro-batch of ``mode`` split into encode, copy in,
    step and snapshot (host clock, each ending in a synchronize), median
    of ``reps``. With ``trace``, one more step under ``torch.profiler``:
    the card's busy time in it (the sum of its CUDA kernels and copies)
    and that time's share of the median unprofiled step (None where the
    trace shows no device time)."""
    import torch
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    op = ftrl_op(warm, mode).link_from(
        MemSourceStreamOp(train, batch_size=FTRL_BATCH))
    tr = op.trainer
    med, dev, z, n = trainer_stages(tr, train.first_n(FTRL_BATCH), reps)
    if not trace:
        return med
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, n, _ = tr.step(dev, z, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None \
                and str(e.device_type).endswith("CUDA"):
            dev_us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0)))
    med["profiled_step_ms"] = wall * 1e3
    med["device_busy_ms"] = dev_us / 1e3
    med["device_busy_share"] = (dev_us / 1e3 / med["step"]) if dev_us > 0 \
        else None
    return med


def ftrl_splits(warm, train, kf):
    """:func:`ftrl_split` of one micro-batch of each mode, then the card's
    busy time under one more profiled step of each (its share of the
    unprofiled step): a step measured after a profiled one runs slower,
    so every unprofiled split comes first. Returns ({mode: split},
    {mode: the launches of its split})."""
    modes = ("sample", "staleness", "chained")
    splits, launches = {}, {}
    for mode in modes:
        kf.reset_launch_counts()
        splits[mode] = ftrl_split(warm, train, mode)
        launches[mode] = kf.launch_counts()
    for mode in modes:
        traced = ftrl_split(warm, train, mode, reps=1, trace=True)
        busy = traced["device_busy_ms"]
        splits[mode].update(profiled_step_ms=traced["profiled_step_ms"],
                            device_busy_ms=busy,
                            device_busy_share=busy / splits[mode]["step"]
                            if busy else None)
    return splits, launches


def phase_ftrl_main(kf, ks, rng):
    """The FTRL main path and the other two modes on the card (f32)."""
    import torch
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.types import TableSchema
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlPredictStreamOp
    from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    from alink_tpu_torch.operator.base import StreamOperator
    from alink_tpu_torch.serving import CompiledPredictor
    t0 = time.perf_counter()
    warm = ftrl_warm_model(rng)
    train = criteo_ftrl_rows(1, FTRL_BATCH * FTRL_TRAIN_BATCHES)
    held = criteo_ftrl_rows(2, 1024 * FTRL_HELD_BATCHES)
    print(f"ftrl data: {train.num_rows} training and {held.num_rows} "
          f"held-out rows, warm model table, {time.perf_counter() - t0:.3f} s")
    out = {}

    # -- the main path: sample mode, train + hot-swapped predict ----------
    # first the trainer's stream alone (throughput, snapshots), then the
    # main path: execute() replays the training under the predictor, and
    # its launches are counted from 0 on their own
    ftrl = ftrl_op(warm, "sample", time_interval=2.0).link_from(
        MemSourceStreamOp(train, batch_size=FTRL_BATCH))
    kf.reset_launch_counts()
    snaps, secs = drain_timed(ftrl)
    drain_launches = kf.launch_counts()
    pred = FtrlPredictStreamOp(warm, prediction_col="pred",
                               vector_col="vec").link_from(
        ftrl, MemSourceStreamOp(held, batch_size=1024))
    sink = CollectSinkStreamOp().link_from(pred)
    kf.reset_launch_counts()
    StreamOperator.execute()
    launches = kf.launch_counts()
    require(launches["ftrl_gather_pair"] > 0
            and launches["ftrl_scatter_add"] > 0,
            f"the train + hot-swap predict run launched every state "
            f"kernel: {launches}")
    # four launches per 4-row chunk and none per sample: 1024 gathers of z
    # and n, 1024 walks and 2048 scatter-adds a 4096-row micro-batch
    chunks = FTRL_BATCH // 4 * FTRL_TRAIN_BATCHES
    require(drain_launches == {"ftrl_gather": 0, "ftrl_gather_pair": chunks,
                               "ftrl_walk": chunks,
                               "ftrl_scatter_add": 2 * chunks},
            f"the sample step launches 4 kernels a chunk: {drain_launches}")
    require(launches == drain_launches,
            f"the replayed training launched what the drain did: "
            f"{launches} vs {drain_launches}")
    scored = sink.get_and_remove_values()
    require(scored.num_rows == held.num_rows, "every held-out row scored")
    require([t for t, _ in snaps] == [2.0, 4.0, 6.0],
            f"snapshots every 2 micro-batches: {[t for t, _ in snaps]}")
    pl = ftrl.progressive_logloss()
    require(len(pl) == FTRL_TRAIN_BATCHES and all(np.isfinite(v)
                                                 for _, v in pl),
            "finite progressive log loss per micro-batch")
    coefs = [LinearModelDataConverter.load_table(s).coef for _, s in snaps]
    require(all(np.isfinite(c).all() and c.shape == (FEATURES + 1,)
                for c in coefs), "finite snapshot coefficients")
    out["sample"] = {"micro_batches": FTRL_TRAIN_BATCHES,
                     "samples_per_s": train.num_rows / secs,
                     "drain_s": secs, "drain_launches": drain_launches,
                     "launches_per_micro_batch": {
                         k: v / FTRL_TRAIN_BATCHES
                         for k, v in drain_launches.items()},
                     "main_path_launches": launches,
                     "progressive_logloss": pl}
    print(f"ftrl sample: {train.num_rows} rows in {secs:.3f} s "
          f"({train.num_rows / secs:.1f} samples/s), launches of the train "
          f"+ hot-swap predict run {launches}, "
          f"progressive log loss first {pl[0][1]} last {pl[-1][1]}")

    # the last snapshot hot-swapped into slice 1's CompiledPredictor
    wt = warm.get_output_table()
    mapper = LinearModelMapper(wt.schema, TableSchema(["vec"], ["VECTOR"]),
                               Params({"prediction_col": "pred",
                                       "vector_col": "vec"}))
    mapper.load_model(wt)
    gpu = CompiledPredictor(mapper)
    gpu.swap_model(snaps[-1][1])
    last = held.take_rows(np.arange(6 * 1024, held.num_rows)).select(["vec"])
    card = [str(v) for v in gpu.predict_table(last).col("pred")]
    ftrl_labels = [str(v) for v in
                   scored.take_rows(np.arange(6 * 1024,
                                              held.num_rows)).col("pred")]
    host = gpu._active.mapper
    s_host = host.predict_scores(last)
    c = coefs[-1]
    terms = np.asarray([abs(c[0]) + np.abs(c[1 + v.indices]).sum()
                        for v in last.col("vec")])
    clear = np.abs(s_host) > 64 * 2.0 ** -24 * terms
    require(all(a == b for a, b, ok in zip(card, ftrl_labels, clear) if ok),
            "CompiledPredictor labels equal FtrlPredictStreamOp's")
    out["swap"] = {"rows": len(card), "rows_in_rounding_band":
                   int((~clear).sum()),
                   "labels_equal": sum(a == b for a, b in
                                       zip(card, ftrl_labels))}
    print(f"ftrl hot swap: {out['swap']}")

    # -- the other two modes, 2 micro-batches each -----------------------
    two = train.first_n(2 * FTRL_BATCH)
    for mode, kernels in (("staleness", ("ftrl_gather", "ftrl_scatter_add")),
                          ("chained", ("ftrl_gather_pair", "ftrl_walk",
                                       "ftrl_scatter_add"))):
        op = ftrl_op(warm, mode, time_interval=1e9).link_from(
            MemSourceStreamOp(two, batch_size=FTRL_BATCH))
        kf.reset_launch_counts()
        snaps_m, secs = drain_timed(op)
        counts = kf.launch_counts()
        require(all(counts[k] > 0 for k in kernels),
                f"the {mode} path launched {kernels}: {counts}")
        if mode == "chained":
            # 256 chunks of 16 rows a micro-batch: 4 launches each
            chunks = 2 * FTRL_BATCH // CHAIN_K
            require(counts == {"ftrl_gather": 0, "ftrl_gather_pair": chunks,
                               "ftrl_walk": chunks,
                               "ftrl_scatter_add": 2 * chunks},
                    f"the chained step launches 4 kernels a chunk: "
                    f"{counts}")
        c = LinearModelDataConverter.load_table(snaps_m[-1][1]).coef
        require(bool(np.isfinite(c).all()), f"{mode} finite coefficients")
        pl = op.progressive_logloss()
        out[mode] = {"micro_batches": 2, "samples_per_s": two.num_rows / secs,
                     "drain_s": secs, "launches": counts,
                     "launches_per_micro_batch": {k: v / 2
                                                  for k, v in counts.items()},
                     "progressive_logloss": pl}
        print(f"ftrl {mode}: {two.num_rows} rows in {secs:.3f} s "
              f"({two.num_rows / secs:.1f} samples/s), launches {counts}")

    out["split_ms"], _ = ftrl_splits(warm, train, kf)
    for mode, split in out["split_ms"].items():
        print(f"ftrl {mode} micro-batch split (ms): {split}")
    t0 = time.perf_counter()
    out["card_vs_cpu_f64"] = ftrl_card_vs_cpu(warm, train)
    print(f"ftrl card vs CPU, float64, 2 micro-batches "
          f"({time.perf_counter() - t0:.1f} s): {out['card_vs_cpu_f64']}")
    return out


# ---------------------------------------------------------------------------
# trees: the level-histogram kernel, GBDT training and tree serving
# ---------------------------------------------------------------------------

ADULT_COLS = [f"f{j}" for j in range(ADULT_F)]


def adult_data(n, seed=0):
    """bench.py's ``bench_gbdt`` rows: 6 continuous ``randn`` columns and
    8 integer codes 0-11, binary labels from its planted margin. Returns
    (X float32 (n, 14), y, the table with a ``label`` column)."""
    from alink_tpu_torch.common.mtable import MTable
    rng = np.random.RandomState(seed)
    Xc = rng.randn(n, 6).astype(np.float32)
    Xd = rng.randint(0, 12, size=(n, 8)).astype(np.float32)
    X = np.concatenate([Xc, Xd], 1)
    margin = (Xc[:, 0] + 0.8 * Xc[:, 1] * (Xd[:, 0] > 5)
              - 0.6 * (Xd[:, 1] % 3) + 0.4 * Xc[:, 2])
    y = (margin + 0.3 * rng.randn(n) > 0).astype(np.int64)
    cols = {c: X[:, j].astype(np.float64) for j, c in enumerate(ADULT_COLS)}
    cols["label"] = y
    schema = ", ".join(f"{c} DOUBLE" for c in ADULT_COLS) + ", label LONG"
    return X, y, MTable(cols, schema)


def ptxas_report(log):
    """{kernel instantiation: "N registers, M bytes smem"} from -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and name:
            out[name] = line.split("Used", 1)[1].strip()
    return out


def hist_inputs(X, rng, n_nodes, m, dev, kind="level"):
    """The binned adult table as the trainer keeps it (a column-major
    copy's transpose), GBDT-like stats and node ids of a level. Kinds
    that the sorted design could get wrong change one of them:
    ``one_slot`` puts every row in bin 0 (with one node, one run of n
    per feature), ``sparse_bins`` leaves 61 of 64 bins of every column
    empty, and ``signed_zeros`` zeroes a fifth of the rows' stats, half
    of them to -0.0, inside the runs."""
    import torch
    from alink_tpu_torch.operator.common.tree.hist import (bin_data,
                                                           make_bin_edges)
    n = X.shape[0]
    binned = bin_data(X, make_bin_edges(X, GBDT_BINS, device=False))
    if kind == "one_slot":
        binned = np.zeros_like(binned)
    elif kind == "sparse_bins":
        binned = binned % 3 * 31
    g = rng.uniform(-1, 1, n)
    h = rng.uniform(0, 0.25, n)
    stats = np.stack([g, h, np.ones(n)] + [rng.uniform(0, 1, n)] * (m - 3),
                     1).astype(np.float32)
    if kind == "signed_zeros":
        zero = rng.rand(n)
        stats[zero < 0.1] = 0.0
        stats[(zero >= 0.1) & (zero < 0.2)] = -0.0
    node_id = rng.randint(0, n_nodes, n).astype(np.int32)
    bt = torch.from_numpy(np.ascontiguousarray(binned.T)).to(dev).t()
    return (bt, torch.from_numpy(stats).to(dev),
            torch.from_numpy(node_id).to(dev))


def phase_tree_hist(kh, build_log, dev):
    """B6 against its plain version on the card, bitwise, at the main
    path's shapes and beyond; times (CUDA events and the profiler's
    device time over the kernel's passes), bounds, scratch and the
    library yardstick."""
    import torch
    rng = np.random.RandomState(7)
    X, _, _ = adult_data(ADULT_N)
    XL, _, _ = adult_data(ADULT_LARGE_N)
    shapes = [("level", X, n, 64, 3) for n in (1, 2, 4, 8, 16, 32)]
    shapes += [("leaf", X, 64, 1, 3), ("gini", X, 8, 64, 4),
               ("tiles", X, 256, 64, 3), ("level", XL, 32, 64, 3)]
    # shapes the sorted design could get wrong: one run of every row, the
    # leaf call and one run at 488,420 rows, a last tile of one row, a
    # single row, columns of mostly empty bins, signed zeros inside runs,
    # and 19,200 keys: two key chunks, the second one partial
    shapes += [("one_slot", X, 1, 1, 3), ("one_slot", XL, 1, 1, 3),
               ("leaf", XL, 64, 1, 3), ("level", X[:4097], 32, 64, 3),
               ("level", X[:1], 32, 64, 3), ("sparse_bins", X, 8, 64, 3),
               ("signed_zeros", X, 4, 64, 3), ("key_chunks", X, 300, 64, 3)]
    rec = {}
    for kind, Xs, n_nodes, n_bins, m in shapes:
        n = Xs.shape[0]
        binned, stats, node_id = hist_inputs(Xs, rng, n_nodes, m, dev, kind)
        if kind == "leaf":
            binned = torch.zeros((1, 1), dtype=torch.int32,
                                 device=dev).expand(n, 1)
        F = binned.shape[1]
        args = (binned, stats, node_id, n_nodes, n_bins)
        got = kh.level_hist(*args)
        want = kh.level_hist_plain(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        require(bool(torch.isfinite(got).all()), f"tree_hist {kind} finite")
        require(torch.equal(bits(got), bits(want)),
                f"tree_hist {kind} n={n} nodes={n_nodes} m={m} bitwise vs its "
                f"plain version (max abs err {err})")
        # the library yardstick: one index_add_ over the (row, feature)
        # pairs, as the JAX package's CPU default scatters them (its
        # order is not fixed on the card)
        slot = ((node_id.long()[:, None] * F
                 + torch.arange(F, device=dev)[None, :]) * n_bins
                + binned.long()).reshape(-1)
        rep = stats.repeat_interleave(F, dim=0)
        flat = torch.zeros((n_nodes * F * n_bins, m), device=dev)
        nbytes = (0 if kind == "leaf" else n * F * 4) + n * 4 + n * m * 4 \
            + n_nodes * F * n_bins * m * 4
        b_ms, b_by = _bound(nbytes, n * F * m, "f32")
        key = f"{kind} n={n} F={F} nodes={n_nodes} bins={n_bins} m={m}"
        dev_ms, passes = device_ms(lambda: kh.level_hist(*args), "hist_")
        # the plain version walks the longest run one round at a time: a
        # run of every row is timed once, after the check's call
        long_run = kind == "one_slot"
        rec[key] = {
            "bitwise": True, "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: kh.level_hist(*args)),
            "device_ms": dev_ms, "passes_ms": passes,
            "plain_ms": cuda_ms(lambda: kh.level_hist_plain(*args),
                                trials=1 if long_run else 3, reps=1,
                                warm=0 if long_run else 3),
            "library_ms": cuda_ms(lambda: flat.index_add_(0, slot, rep)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "scratch_bytes": kh._hist_plan(n, F, n_nodes,
                                           n_bins).scratch_bytes}
        r = rec[key]
        print(f"tree_hist {key}: bitwise=True kernel_ms={r['kernel_ms']} "
              f"device_ms={dev_ms} passes_ms={passes} plain_ms="
              f"{r['plain_ms']} index_add_ms={r['library_ms']} bound_ms="
              f"{b_ms} ({b_by}) scratch_bytes={r['scratch_bytes']}",
              flush=True)
    regs = ptxas_report(build_log)
    print(f"tree_hist ptxas: {regs}")
    return rec, regs


def host_tree_scores(m, X):
    """map_table's GBDT score loop (base + sum of lr * leaf, tree by
    tree, in float64), kept apart to compare raw scores."""
    from alink_tpu_torch.operator.common.tree.hist import tree_apply_values
    s = np.full(X.shape[0], m.base_score)
    for t in range(m.features.shape[0]):
        leaf = tree_apply_values(X, m.features[t], m.thresholds[t],
                                 m.max_depth)
        s += m.learning_rate * m.leaf_values[t][leaf]
    return s


def binned_scores(m, X):
    """GBDT scores as training sees the rows, on the card: each tree
    descended on the rows' bins (``tree_apply_binned`` with the split
    masks), base + sum of lr * leaf in float64. Also the number of rows
    that reach another leaf in some tree under the host mapper's
    thresholds (``x > edge`` goes right there, while a value equal to an
    edge has the bin above it in training)."""
    import torch
    from alink_tpu_torch.operator.common.tree.hist import (
        bin_data, make_bin_edges, tree_apply_binned, tree_apply_values)
    X64 = X.astype(np.float64)
    binned = torch.from_numpy(bin_data(X64, make_bin_edges(
        X64, GBDT_BINS))).cuda()
    masks = torch.from_numpy(m.split_masks).cuda()
    feats = torch.from_numpy(m.features).cuda()
    s = np.full(X.shape[0], m.base_score)
    moved = np.zeros(X.shape[0], bool)
    for t in range(m.features.shape[0]):
        leaf = tree_apply_binned(binned, feats[t], None, m.max_depth,
                                 masks[t]).cpu().numpy()
        s += m.learning_rate * m.leaf_values[t][leaf]
        moved |= leaf != tree_apply_values(X64, m.features[t],
                                           m.thresholds[t], m.max_depth)
    return s, int(moved.sum())


def rank_auc(y, s):
    """Rank-based AUC (ties share their average rank)."""
    order = np.argsort(s, kind="mergesort")
    ss = s[order]
    ranks = np.empty(len(s))
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and ss[j + 1] == ss[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1
        i = j + 1
    pos = y == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def gbdt_op(**kw):
    from alink_tpu_torch.operator.batch.classification import GbdtTrainBatchOp
    return GbdtTrainBatchOp(feature_cols=ADULT_COLS, label_col="label",
                            max_depth=GBDT_DEPTH, max_bins=GBDT_BINS,
                            learning_rate=GBDT_LR, **kw)


def gain_margins(trainers):
    """Record, while a training runs, each split node's margin between its
    best gain and the next best one (exact ties, which an empty bin
    makes between two cuts of one partition, are counted apart)."""
    import torch
    made = trainers.make_xgb_gain
    seen = {"margins": [], "ties": 0}

    def recording(lam):
        fn = made(lam)

        def gain(left, right, total, min_leaf):
            g = fn(left, right, total, min_leaf)
            flat = g.reshape(g.shape[0], -1).double()
            top = torch.topk(flat, 2, dim=1).values
            split = top[:, 0] > 1e-9
            gap = (top[:, 0] - top[:, 1])[split]
            seen["ties"] += int((gap == 0).sum())
            seen["margins"] += [(float(d), float(d / t)) for d, t in
                                zip(gap[gap > 0], top[split, 0][gap > 0])]
            return g
        return gain
    return made, recording, seen


class StageTimer:
    """Host-clock time of the stages of a training, each call ending in a
    synchronize: wraps a module's function in place (``undo`` restores)."""

    def __init__(self):
        self.times, self._undo = {}, []

    def wrap(self, mod, name, label):
        import torch
        real = getattr(mod, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.times.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        setattr(mod, name, timed)
        self._undo.append((mod, name, real))

    def undo(self):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)
        self._undo = []


def tree_split(X, y, reps=4):
    """One tree of the main path split into histogram (the 7 kernel
    launches), split search (prefix sums, gains, argmax), descent and the
    rest of the superstep (gradients, leaf values, score update), host
    clock, each ending in a synchronize; median over supersteps 2..reps.
    Then one more superstep under ``torch.profiler``: the card's busy
    time (its kernels and copies) and the device operations it ran."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.engine import comqueue
    from alink_tpu_torch.operator.common.tree import hist, trainers
    p = trainers.TreeTrainParams(num_trees=reps, max_depth=GBDT_DEPTH,
                                 n_bins=GBDT_BINS, learning_rate=GBDT_LR,
                                 min_samples_leaf=2)
    env = MLEnvironment()
    st = StageTimer()
    st.wrap(hist, "level_hist", "histogram")
    st.wrap(hist, "_split_search", "split_search")
    st.wrap(hist, "_descend", "descent")
    st.wrap(comqueue._FnStage, "calc", "superstep")
    try:
        trainers.gbdt_train(X, y, p, False, env=env)
    finally:
        st.undo()
    per = {k: v for k, v in st.times.items()}
    L = TREE_LAUNCHES_PER_TREE
    steps = len(per["superstep"])
    rows = []
    for s_ in range(1, steps):                     # skip the init pass
        row = {"histogram": sum(per["histogram"][s_ * L:(s_ + 1) * L]),
               "split_search": sum(per["split_search"][
                   s_ * GBDT_DEPTH:(s_ + 1) * GBDT_DEPTH]),
               "descent": sum(per["descent"][
                   s_ * GBDT_DEPTH:(s_ + 1) * GBDT_DEPTH]),
               "superstep": per["superstep"][s_]}
        row["gradients_leaves_score_update"] = row["superstep"] - (
            row["histogram"] + row["split_search"] + row["descent"])
        rows.append(row)
    med = {k: float(np.median([r[k] for r in rows])) * 1e3 for k in rows[0]}
    # the profiled superstep: the last one of a 3-tree training
    from torch.profiler import ProfilerActivity, profile
    real_calc = comqueue._FnStage.calc
    prof_box = {}

    def calc(self, ctx):
        if ctx.step_no != 3:
            return real_calc(self, ctx)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_calc(self, ctx)
            torch.cuda.synchronize()
            prof_box["wall"] = time.perf_counter() - t0
        prof_box["prof"] = prof
    comqueue._FnStage.calc = calc
    try:
        p.num_trees = 3
        trainers.gbdt_train(X, y, p, False, env=env)
    finally:
        comqueue._FnStage.calc = real_calc
    dev_us, dev_ops = 0.0, 0
    for e in prof_box["prof"].key_averages():
        if getattr(e, "device_type", None) is not None \
                and str(e.device_type).endswith("CUDA"):
            dev_us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0)))
            dev_ops += int(e.count)
    med["profiled_superstep_ms"] = prof_box["wall"] * 1e3
    med["device_busy_ms"] = dev_us / 1e3
    med["device_ops_per_tree"] = dev_ops
    med["device_busy_share"] = (dev_us / 1e3 / med["superstep"]) \
        if dev_us > 0 else None
    return med


def phase_gbdt_main(kh):
    """The GBDT main path on the card (see the module docstring)."""
    import torch
    from alink_tpu_torch.operator.batch.classification import (
        GbdtPredictBatchOp, TreeModelDataConverter)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.tree import trainers
    X, y, table = adult_data(ADULT_N)
    src = MemSourceBatchOp(table)
    out = {}
    # -- the main path, its launches counted from 0 ----------------------
    torch.cuda.synchronize()
    kh.reset_launch_counts()
    t0 = time.perf_counter()
    train = gbdt_op(num_trees=GBDT_TREES).link_from(src)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pred = GbdtPredictBatchOp(prediction_col="pred",
                              prediction_detail_col="detail").link_from(
        train, src)
    launches = kh.launch_counts()["tree_hist"]
    require(launches == GBDT_TREES * TREE_LAUNCHES_PER_TREE,
            f"the main path launched the histogram kernel 7 times a tree: "
            f"{launches}")
    probs = np.asarray([json.loads(d)["1"] for d in pred.get_output_table()
                        .col("detail")])
    labels = np.asarray(pred.get_output_table().col("pred"))
    require(bool(np.isfinite(probs).all()) and probs.shape == (ADULT_N,),
            "finite probabilities for every row")
    loss = np.asarray(train.get_side_output(0).get_output_table().col("loss"))
    model = TreeModelDataConverter().load_model(train.get_output_table())
    s_bin, skew = binned_scores(model, X)
    auc_bin = rank_auc(y, s_bin)
    require(auc_bin > 0.9 and loss[-1] < loss[0],
            f"the model learned: AUC {auc_bin} on the trees' own bins, loss "
            f"{loss[0]} -> {loss[-1]}")
    auc = rank_auc(y, probs)
    acc = float((labels == y).mean())
    out.update({"train_s": secs, "samples_per_s": ADULT_N * GBDT_TREES / secs,
                "launches": launches, "train_auc": auc_bin,
                "predict_op_auc": auc, "predict_op_accuracy": acc,
                "edge_skew_rows": skew,
                "loss_first": float(loss[0]), "loss_last": float(loss[-1])})
    print(f"gbdt main path: {GBDT_TREES} trees on {ADULT_N} rows in "
          f"{secs:.4f} s ({out['samples_per_s']:.1f} samples/s), {launches} "
          f"histogram launches, training AUC {auc_bin} (the trees' bins), "
          f"GbdtPredictBatchOp AUC {auc} and accuracy {acc} (thresholds; "
          f"{skew} rows reach another leaf in some tree), loss "
          f"{loss[0]} -> {loss[-1]}", flush=True)

    # -- reproducible: a second card training, bitwise the same table ----
    t0 = time.perf_counter()
    again = gbdt_op(num_trees=GBDT_TREES).link_from(src)
    torch.cuda.synchronize()
    out["second_train_s"] = time.perf_counter() - t0
    require(again.get_output_table().to_rows()
            == train.get_output_table().to_rows(),
            "two card trainings give bitwise equal model tables")

    # -- the card against the port on the CPU, first 5 trees --------------
    made, recording, seen = gain_margins(trainers)
    trainers.make_xgb_gain = recording
    try:
        t0 = time.perf_counter()
        cpu = gbdt_op(num_trees=GBDT_CPU_TREES, device="cpu").link_from(src)
        out["cpu_train_s"] = time.perf_counter() - t0
    finally:
        trainers.make_xgb_gain = made
    conv = TreeModelDataConverter()
    mc, mg = conv.load_model(cpu.get_output_table()), \
        conv.load_model(train.get_output_table())
    k = GBDT_CPU_TREES
    for name in ("features", "thresholds", "split_masks"):
        require(np.array_equal(getattr(mc, name), getattr(mg, name)[:k]),
                f"card {name} of the first {k} trees equal the CPU run's")
    lv_c, lv_g = mc.leaf_values, mg.leaf_values[:k]
    require(bool(np.allclose(lv_g, lv_c, rtol=1e-4, atol=0)),
            "leaf values within rtol 1e-4 of the CPU run")
    loss_c = np.asarray(cpu.get_side_output(0).get_output_table().col("loss"))
    require(bool(np.allclose(loss[:k], loss_c, rtol=1e-4, atol=0)),
            "loss curve within rtol 1e-4 of the CPU run")
    margins = seen["margins"]
    out["card_vs_cpu"] = {
        "trees": k, "leaf_values_bitwise": bool(np.array_equal(lv_g, lv_c)),
        "leaf_max_abs_err": float(np.abs(lv_g - lv_c).max()),
        "loss_max_abs_err": float(np.abs(loss[:k] - loss_c).max()),
        "split_nodes": len(margins) + seen["ties"],
        "exact_ties": seen["ties"],
        "min_gain_margin": min(m_[0] for m_ in margins),
        "min_relative_gain_margin": min(m_[1] for m_ in margins)}
    print(f"gbdt card vs CPU, first {k} trees: {out['card_vs_cpu']}",
          flush=True)

    # -- one tree split by stage, and the card's busy share --------------
    out["tree_split_ms"] = tree_split(X, y.astype(np.float32))
    print(f"gbdt one tree, ms per stage: {out['tree_split_ms']}", flush=True)

    # -- 10 trees at 488,420 rows, device binning included ---------------
    XL, yl, tl = adult_data(ADULT_LARGE_N)
    st = StageTimer()
    st.wrap(trainers, "make_bin_edges", "binning")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = gbdt_op(num_trees=GBDT_LARGE_TREES).link_from(
            MemSourceBatchOp(tl))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        st.undo()
    lossl = np.asarray(big.get_side_output(0).get_output_table().col("loss"))
    require(bool(np.isfinite(lossl).all()) and lossl[-1] < lossl[0],
            "the 488,420-row training learned")
    out["large"] = {"rows": ADULT_LARGE_N, "trees": GBDT_LARGE_TREES,
                    "train_s": secs,
                    "samples_per_s": ADULT_LARGE_N * GBDT_LARGE_TREES / secs,
                    "binning_s": st.times["binning"][0],
                    "loss_last": float(lossl[-1])}
    print(f"gbdt large: {out['large']}", flush=True)
    return out, train, table


def phase_tree_serving(train):
    """Tree serving through CompiledPredictor (float64 ship)."""
    import torch
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.operator.batch.classification import TreeModelMapper
    from alink_tpu_torch.serving import CompiledPredictor
    _, _, t = adult_data(N_SERVE, seed=1)
    req = t.select(ADULT_COLS)
    mt = train.get_output_table()
    mapper = TreeModelMapper(mt.schema, req.schema,
                             Params({"prediction_col": "pred",
                                     "prediction_detail_col": "detail"}))
    mapper.load_model(mt)
    gpu = CompiledPredictor(mapper, ship_dtype=torch.float64)
    t0 = time.perf_counter()
    out = gpu.predict_table(req)
    secs = time.perf_counter() - t0
    host = mapper.map_table(req)
    s_gpu = gpu.predict_scores(req)
    s_host = host_tree_scores(mapper.model, mapper._encode_matrix(req))
    require(s_gpu.dtype == np.float64 and s_gpu.shape == (N_SERVE,),
            "tree score dtype/shape")
    require(np.array_equal(s_gpu.view(np.int64), s_host.view(np.int64)),
            "card tree scores (float64) bitwise equal to the host loop")
    for c in ("pred", "detail"):
        require(list(out.col(c)) == list(host.col(c)),
                f"card {c} equal to map_table's")
    rec = {"rows": N_SERVE, "rows_per_s": N_SERVE / secs,
           "buckets": bucket_latency(gpu, req)}
    print(f"tree serving: {N_SERVE} rows in {secs:.4f} s "
          f"({rec['rows_per_s']:.1f} rows/s); buckets {rec['buckets']}",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# linear training: the ordered gradient kernel, L-BFGS, the chained main path
# ---------------------------------------------------------------------------

LR_SRC = "alink_tpu_torch/kernels/csrc/linear_grad.cu"
PLAN_SRC = "alink_tpu_torch/kernels/csrc/run_plan.cu"
# bench.py's bench_logreg: 200,000 rows of 32 fields of 2048 (plus the
# intercept field that LogisticRegressionTrainBatchOp prepends), l2 1e-4
LR_ROWS, LR_FIELDS, LR_FIELD_SIZE, LR_L2 = 200_000, 32, 2048, 1e-4
LR_TIMED_STEPS, LR_CHECK_STEPS = 30, 10
LR_PROFILED = (5, 9)                     # supersteps under the profiler
LR_MAIN_ROWS, LR_HELD_ROWS = 100_000, 8192
COO_WIDTH = NNZ + 1                      # 39 slots and the intercept


def fb_criteo(seed, n=LR_ROWS):
    """``bench.py::make_ctr_fieldblock`` with the intercept field in
    front, as the trainer lays it out: (n, 33) field-local indices and
    {-1, +1} float32 labels."""
    fb, y = ctr_fieldblock(n, seed)
    return np.concatenate([np.zeros((n, 1), np.int32), fb], 1), y


def ctr_fieldblock(n, seed):
    """``bench.py::make_ctr_fieldblock`` (bench.py:488): (n, 32) int32
    field-local indices of 32 fields of 2048 and {-1, +1} float32 labels
    from the logistic of a seeded sparse true model."""
    rng = np.random.RandomState(seed)
    fb = rng.randint(0, LR_FIELD_SIZE, size=(n, LR_FIELDS)).astype(np.int32)
    dim = LR_FIELDS * LR_FIELD_SIZE
    w_true = (rng.randn(dim) * (rng.rand(dim) < 0.05)).astype(np.float32)
    flat = fb + (np.arange(LR_FIELDS, dtype=np.int32) * LR_FIELD_SIZE)[None]
    margin = w_true[flat].sum(-1)
    y = np.where(rng.rand(n) < 1.0 / (1.0 + np.exp(-margin)), 1.0,
                 -1.0).astype(np.float32)
    return fb, y


def grad_inputs(rng, case, dtype):
    """(keys (n, w) int32, values, c, dim) of one gradient-kernel case."""
    if case == "fieldblock":
        fb, _ = fb_criteo(7)
        keys = fb + (np.arange(LR_FIELDS + 1, dtype=np.int32)
                     * LR_FIELD_SIZE)[None]
        n = keys.shape[0]
        return (keys, np.ones(keys.shape, dtype),
                rng.standard_normal(n).astype(dtype),
                (LR_FIELDS + 1) * LR_FIELD_SIZE)
    if case == "fieldblock_bulk":           # the bulk alone: no intercept
        keys, val, c, dim = grad_inputs(rng, "fieldblock", dtype)
        return np.ascontiguousarray(keys[:, 1:]), \
            np.ascontiguousarray(val[:, 1:]), c, dim
    if case == "coo_bulk":                  # the bulk alone: no intercept
        keys, val, c, dim = grad_inputs(rng, "coo", dtype)
        return np.ascontiguousarray(keys[:, 1:]), \
            np.ascontiguousarray(val[:, 1:]), c, dim
    if case == "intercept":                 # the intercept's run alone
        n = LR_ROWS
        return (np.zeros((n, 1), np.int32), np.ones((n, 1), dtype),
                rng.standard_normal(n).astype(dtype),
                (LR_FIELDS + 1) * LR_FIELD_SIZE)
    if case in ("heavy_runs", "heavy_many", "heavy_specials"):
        return heavy_inputs(rng, case, dtype)
    if case in ("fb_step", "stream_step"):
        # the field-blocked batch step's two linear_grad launches (phase
        # 14): bench_ftrl's 4096 x 40 fields of 1648 and its stream's
        # 16,384 x (the intercept field and 3) of 1648, field 0 the
        # intercept (one run of every row), c the step's ones
        n, f = (BF_ROWS, BF_FIELDS) if case == "fb_step" else (ST_MICRO, 4)
        keys = (rng.integers(0, BF_S, (n, f))
                + np.arange(f) * BF_S).astype(np.int32)
        keys[:, 0] = 0
        return (keys, rng.standard_normal((n, f)).astype(dtype),
                np.ones(n, dtype), f * BF_S)
    if case == "coo":
        n = LR_MAIN_ROWS
        keys = np.zeros((n, COO_WIDTH), np.int32)
        keys[:, 1:] = 1 + np.sort(rng.integers(0, FEATURES, (n, NNZ)), 1)
        val = np.ones((n, COO_WIDTH), dtype)
        val[:, 1:14] = np.log1p(rng.poisson(3.0, (n, 13)))
        return keys, val, rng.standard_normal(n).astype(dtype), FEATURES + 1
    if case == "one_slot":
        n, w, dim = 50_000, 8, 3
        keys = np.zeros((n, w), np.int32)
    elif case == "one_row":
        n, w, dim = 1, COO_WIDTH, FEATURES + 1
        keys = rng.choice(dim, (1, w), replace=False).astype(np.int32)
    elif case == "unhit":
        n, w, dim = 4096, 16, 1 << 14
        keys = (2 * rng.integers(0, dim // 2, (n, w))).astype(np.int32)
    else:                                           # specials
        n, w, dim = 5000, 16, 64
        keys = rng.integers(0, dim, (n, w)).astype(np.int32)
    val = rng.standard_normal((n, w)).astype(dtype)
    c = rng.standard_normal(n).astype(dtype)
    if case in ("specials", "one_slot"):
        val[rng.random((n, w)) < 0.01] = -0.0
        c[rng.random(n) < 0.01] = -0.0
        val[11, 3], val[n // 2, 5], val[n - 7, 1] = np.nan, np.inf, -np.inf
    return keys, val, c, dim


def heavy_inputs(rng, case, dtype):
    """Designs of heavy runs (at least the kernel's ``HEAVY_MIN`` terms).
    ``heavy_runs``: 300,000 rows x 6 over 2^16 slots, heavy runs of
    300,000 (every row: the ring's 16,384 terms 18 times over), 150,000,
    42,858, two of 3000 (a tie), one of exactly ``HEAVY_MIN`` and one a
    term short of it, medium runs of about 400 and 1600 and a short bulk.
    ``heavy_many``: 90 heavy runs of about 2700 and an intercept, more
    runs than the launch has clusters. ``heavy_specials``: four heavy runs
    that carry NaN, +-inf and -0.0 in the values and in c."""
    from alink_tpu_torch.kernels.linear import HEAVY_MIN
    if case == "heavy_many":
        n, w, dim = 30_000, 8, 91
        keys = rng.integers(1, dim, (n, w)).astype(np.int32)
        keys[:, 0] = 0
        return (keys, rng.standard_normal((n, w)).astype(dtype),
                rng.standard_normal(n).astype(dtype), dim)
    if case == "heavy_runs":
        n, w, dim = 300_000, 6, 1 << 16
        rows = np.arange(n)
        keys = rng.integers(16, dim, (n, w)).astype(np.int32)
        keys[:, 0] = 0
        keys[:, 1] = np.where(rows % 2 == 0, 1, rng.integers(16, 1040, n))
        keys[:, 2] = np.where(rows % 7 == 0, 2, rng.integers(16, 1040, n))
        keys[rows % 100 == 0, 3] = 3
        keys[rows % 100 == 1, 3] = 4
        keys[np.flatnonzero(rows % 100 == 2)[:HEAVY_MIN], 3] = 5
        keys[np.flatnonzero(rows % 100 == 3)[:HEAVY_MIN - 1], 3] = 6
        keys[:, 4] = rng.integers(16, 272, n)
        return (keys, rng.standard_normal((n, w)).astype(dtype),
                rng.standard_normal(n).astype(dtype), dim)
    n, w, dim = 40_000, 4, 512                           # heavy_specials
    rows = np.arange(n)
    keys = rng.integers(8, dim, (n, w)).astype(np.int32)
    keys[:, 0] = 0
    keys[rows % 2 == 0, 1] = 1
    keys[rows % 4 == 1, 2] = 2
    keys[rows % 4 == 3, 2] = 3
    val = rng.standard_normal((n, w)).astype(dtype)
    c = rng.standard_normal(n).astype(dtype)
    val[rng.random((n, w)) < 0.01] = -0.0
    c[rng.random(n) < 0.01] = -0.0
    val[123, 0] = np.nan                          # slot 0: NaN
    val[1000, 1], val[1800, 1] = np.inf, -np.inf  # slot 1: inf - inf
    val[41, 2] = np.inf                           # slot 2: +-inf
    val[rows % 4 == 3, 2] = -0.0                  # slot 3: every term +-0
    c[779] = np.inf                               # slots 0 and 2 (and more)
    c[778] = np.nan
    return keys, val, c, dim


GRAD_CASES = ("fieldblock", "coo", "fieldblock_bulk", "fb_step",
              "stream_step", "one_slot", "one_row", "unhit", "specials",
              "heavy_runs", "heavy_many", "heavy_specials")
GRAD_TIMED = ("fieldblock", "coo", "fieldblock_bulk", "fb_step",
              "stream_step")


def grad_case(kl, rng, case, kind, lat):
    """The gradient kernel against its plain version on the same inputs,
    bitwise (a NaN equal to any NaN). The plain version is ``index_add_``,
    ordered on the CPU only, so it runs there; the plans built on the
    card and on the CPU are equal. The main paths' shapes are timed."""
    import torch
    dtype = np.float32 if kind == "f32" else np.float64
    keys, val, c, dim = grad_inputs(rng, case, dtype)
    dev = torch.device("cuda")
    plan = kl.grad_plan(torch.from_numpy(keys).to(dev), dim,
                        torch.from_numpy(val).to(dev))
    cc = torch.from_numpy(c).to(dev)
    got = kl.linear_grad(plan, cc)
    host = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    require(torch.equal(plan.keys.cpu(), host.keys)
            and plan_equal(kl, plan.walk, host.walk),
            f"linear_grad {case} {kind}: the card's plan is the CPU's")
    want = kl.linear_grad_plain(host, torch.from_numpy(c))
    same, raw = same_bits(got.cpu(), want)
    fin = torch.isfinite(want)
    err = float((got.cpu()[fin].double() - want[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    require(same, f"linear_grad {case} {kind} bitwise vs its plain version "
                  f"(max abs err {err})")
    runs, n_heavy, n_medium, _ = kl.plan_counts(host.walk)
    rec = {"bitwise": True, "raw_bits_equal": raw, "max_abs_err": err,
           "positions": int(keys.size), "slots": dim, "runs": runs,
           "heavy_runs": n_heavy, "medium_runs": n_medium}
    if case not in GRAD_TIMED:
        return rec
    P, n, U = keys.size, keys.shape[0], runs
    isz = np.dtype(dtype).itemsize
    longest = int(np.unique(keys, return_counts=True)[1].max())
    # the plan (perm, starts, order, slots), the values and c read once,
    # the gradient written once
    b_ms, b_by = _bound(4 * P + 12 * U + 4 + P * isz + n * isz
                        + dim * isz, 2 * P, kind)
    keys_l = plan.keys.reshape(-1).long()
    call = lambda: kl.linear_grad(plan, cc)                     # noqa: E731
    lib = lambda: torch.zeros(dim, dtype=cc.dtype, device=dev).index_add_(
        0, keys_l, (plan.val * cc[:, None]).reshape(-1))        # noqa: E731
    k_ms, l_ms = cuda_ms_turns(call, lib, trials=9, reps=5)
    k_host, l_host = host_ms_turns(call, lib, trials=9, reps=5)
    cpu_c = torch.from_numpy(c)
    plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        kl.linear_grad_plain(host, cpu_c)
        plain.append((time.perf_counter() - t0) * 1e3)
    dev_ms, dev_seen = device_span_ms(call, "linear_grad_")
    chain_ms = chain_bound_ms(longest, kind, lat)
    rec.update(
        kernel_ms=k_ms, device_ms=dev_ms, device_launches_recorded=dev_seen,
        host_ms=k_host, plain_ms=float(np.median(plain)),
        plain_where="CPU (index_add_ keeps the order there only)",
        library_ms=l_ms, library_device_ms=device_ms(lib)[0],
        library_host_ms=l_host, library_deterministic=False,
        bound_ms=b_ms, bound_by=b_by, longest_run=longest,
        chain_bound_ms=chain_ms, chain_fraction=chain_ms / k_ms)
    return rec


def phase_linear_grad(kl, rng, lat):
    """12(a): every case in f32 and f64."""
    out = {}
    for case in GRAD_CASES:
        for kind in ("f32", "f64"):
            out[f"{case} {kind}"] = grad_case(kl, rng, case, kind, lat)
    return out


class SuperstepClock:
    """Host-clock stamps at the end of each superstep of the optimizers'
    queues (their compare criterion reads the convergence bit, the
    superstep's one host read, and the stamp follows it); optionally
    ``torch.profiler`` over exactly supersteps ``profile[0]`` to
    ``profile[1]``."""

    def __init__(self, profile=None):
        self.stamps, self.profile, self.prof = [], profile, None

    def __enter__(self):
        from alink_tpu_torch.engine import comqueue
        from torch.profiler import ProfilerActivity, profile
        self._cls = comqueue.IterativeComQueue
        self._orig = orig = self._cls.set_compare_criterion
        clock = self
        if self.profile is not None:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])

        def patched(queue, fn):
            def timed(ctx):
                stop = bool(fn(ctx))
                clock.stamps.append(time.perf_counter())
                k = len(clock.stamps)
                if clock.prof is not None:
                    if k == clock.profile[0] - 1:
                        clock.prof.start()
                    elif k == clock.profile[1]:
                        clock.prof.stop()
                return stop
            return orig(queue, timed)
        self._cls.set_compare_criterion = patched
        return self

    def __exit__(self, *exc):
        self._cls.set_compare_criterion = self._orig

    def superstep_ms(self):
        return np.diff(self.stamps) * 1e3

    def profiled(self, by_name=False):
        """(device events by name, their count, device busy ms) of the
        profiled supersteps, summed; with ``by_name`` also the device ms
        of each name."""
        counts, busy, ms = {}, 0.0, {}
        for e in self.prof.key_averages():
            if getattr(e, "device_type", None) is not None \
                    and str(e.device_type).endswith("CUDA"):
                us = float(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0)))
                counts[e.key] = counts.get(e.key, 0) + int(e.count)
                ms[e.key] = ms.get(e.key, 0.0) + us / 1e3
                busy += us / 1e3
        if by_name:
            return counts, sum(counts.values()), busy, ms
        return counts, sum(counts.values()), busy


class StageSplit:
    """Host-clock ms of each stage of the optimizers' supersteps, each
    stage and piece ending in a synchronize: the queue's stages
    (``calc_grad``, ``direction_and_losses``, ``update_model``; the
    identity ``AllReduce`` stages are not timed) and, inside them, the
    objective's ``pieces`` (by default ``UnaryLossObjFunc``'s
    ``calc_grad_eta_shard``: margins, loss, gradient; and
    ``line_losses_shard``: the direction's margins, the 11 losses)."""

    def __init__(self, pieces=None):
        self.times = {}
        self.pieces = pieces

    def _timed(self, name, fn):
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return run

    def __enter__(self):
        from alink_tpu_torch.engine import comqueue
        from alink_tpu_torch.operator.common.optim import objfunc as ob
        pieces = self.pieces or [
            (ob.UnaryLossObjFunc, k)
            for k in ("calc_grad_eta_shard", "line_losses_shard")]
        self._saved = [(comqueue._FnStage, "calc",
                        comqueue._FnStage.calc)] + [
            (cls, k, getattr(cls, k)) for cls, k in pieces]
        split = self
        calc = comqueue._FnStage.calc

        def stage_calc(stage, ctx):
            return split._timed(stage.__name__, calc)(stage, ctx)
        comqueue._FnStage.calc = stage_calc
        for cls, k, fn in self._saved[1:]:
            setattr(cls, k, self._timed(k, fn))
        return self

    def __exit__(self, *exc):
        for cls, k, fn in self._saved:
            setattr(cls, k, fn)

    def raw_medians(self):
        """Median ms of each timed stage and piece, supersteps 2..N."""
        return {k: float(np.median(v[1:])) for k, v in self.times.items()}

    def medians(self):
        """Median ms per superstep of each stage, supersteps 2..N, with
        the pieces split out: gradient (calc_grad), direction (the
        two-loop and the rest of direction_and_losses), line search,
        update."""
        med = self.raw_medians()
        return {"gradient": med["calc_grad"],
                "gradient_objective": med["calc_grad_eta_shard"],
                "direction": med["direction_and_losses"]
                - med["line_losses_shard"],
                "line_search": med["line_losses_shard"],
                "update": med["update_model"],
                "superstep_sum": med["calc_grad"]
                + med["direction_and_losses"] + med["update_model"]}


def host_reads(run, lo=6, hi=11):
    """Synchronizing calls a superstep makes, from PyTorch's sync debug
    mode: those of a ``hi``-superstep run less those of a ``lo``-superstep
    one (the set-up's cancel), over ``hi - lo``."""
    import warnings
    import torch
    counts = []
    for k in (lo, hi):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                run(k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in seen))
    return (counts[1] - counts[0]) / (hi - lo)


def lbfgs_run(data, steps, eps=0.0, device="cuda", warm=True, seed=0,
              **params):
    """``optimize`` (LBFGS) on the bench_logreg objective; returns (coef,
    loss curve, supersteps, seconds). ``params`` go to ``OptimParams``
    (a health monitor, checkpoints)."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
    meta = FieldBlockMeta(LR_FIELDS + 1, LR_FIELD_SIZE)
    obj = ob.UnaryLossObjFunc(ob.LogLossFunc(), meta.dim, l2=LR_L2,
                              reg_free_head=LR_FIELD_SIZE, fb_meta=meta)
    w0 = (np.random.RandomState(123 + seed).randn(meta.dim) * 1e-6).astype(
        data["y"].dtype) if warm else None
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    coef, curve, n = opt.optimize(obj, data, opt.OptimParams(
        method="LBFGS", max_iter=steps, epsilon=eps, **params),
        MLEnvironment(device=device), warm_start=w0)
    return coef, curve, n, time.perf_counter() - t0


def lbfgs_timing(kl, ks, data, seed):
    """The L-BFGS superstep on the card: ms (median of the untraced
    supersteps of a fixed-length run), launches by kernel, device ops and
    busy share of the profiled supersteps, and the stage split (each
    stage ending in a synchronize)."""
    out = {}
    lbfgs_run(data, 3, seed=seed)                      # warm-up: build, plan
    ks.reset_launch_counts()
    kl.reset_launch_counts()
    with SuperstepClock(profile=LR_PROFILED) as clock:
        _, curve, n, secs = lbfgs_run(data, LR_TIMED_STEPS, seed=seed)
    require(n == LR_TIMED_STEPS and np.isfinite(curve).all(),
            "L-BFGS ran its fixed-length supersteps with finite losses")
    per = clock.superstep_ms()          # supersteps 2..N
    traced = np.arange(LR_PROFILED[0] - 2, LR_PROFILED[1] - 1)
    ms = float(np.median(np.delete(per, traced)))   # the untraced ones
    k = LR_PROFILED[1] - LR_PROFILED[0] + 1
    events, total, busy = clock.profiled()
    total, busy = total / k, busy / k
    recorded = sum(v for name, v in events.items()
                   if "serve_sparse_kernel" in name
                   or "linear_grad_" in name) / k
    wrappers = {"serve_sparse": ks.launch_counts()["serve_sparse"] / n,
                "linear_grad": kl.launch_counts()["linear_grad"] / n}
    require(wrappers == {"serve_sparse": 2.0, "linear_grad": 1.0},
            f"a superstep launches 2 margin and 1 gradient kernels: "
            f"{wrappers}")
    out.update(ms_per_superstep=ms, superstep_ms_min=float(per.min()),
               superstep_ms_max=float(per.max()), run_s=secs,
               rows_supersteps_per_s=LR_ROWS / ms * 1e3,
               launches_per_superstep={
                   "by_kernel": wrappers, "device_ops_total": total,
                   "device_ops_by_name": events},
               profiled_superstep_ms=float(np.mean(per[traced])),
               profiler_recorded_port_kernels=recorded,
               device_busy_ms=busy, device_busy_share=busy / ms,
               loss_first=float(curve[0]), loss_last=float(curve[-1]))
    print(f"lbfgs: {ms:.4f} ms a superstep (median of {len(per) - k}), "
          f"{out['rows_supersteps_per_s']:.1f} rows x supersteps/s, "
          f"{total} device ops a superstep ({wrappers}; the profiler "
          f"recorded {recorded} of the 4 port kernels: 2 margins, the "
          f"gradient's 2 launches), busy {busy:.4f} ms "
          f"({busy / ms:.3f})", flush=True)
    with StageSplit() as split:
        lbfgs_run(data, LR_CHECK_STEPS, seed=seed)
    out["stage_ms"] = split.medians()
    print(f"lbfgs superstep by stage (ms, each ending in a synchronize): "
          f"{out['stage_ms']}", flush=True)
    return out


def phase_lbfgs(kl, ks, seed):
    """12(b): L-BFGS at bench_logreg's configuration through ``optimize``
    on the card."""
    fb, y = fb_criteo(0)
    data = {"fb_idx": fb, "y": y, "w": np.ones(LR_ROWS, np.float32)}
    out = {"rows": LR_ROWS, "fields": LR_FIELDS + 1,
           "field_size": LR_FIELD_SIZE, "l2": LR_L2}
    out.update(lbfgs_timing(kl, ks, data, seed))
    reads = host_reads(lambda k: lbfgs_run(data, k, seed=seed))
    require(reads == 1.0, f"a superstep reads the card once (the "
                          f"convergence bit): {reads}")
    out["host_reads_per_superstep"] = reads
    _, conv_curve, n_conv, conv_s = lbfgs_run(data, 100, eps=1e-6,
                                             warm=False)
    out.update(supersteps_to_converge=n_conv, converge_s=conv_s,
               converged_loss=float(conv_curve[-1]))
    # reproducible: two card runs, the same bits
    a = lbfgs_run(data, LR_CHECK_STEPS, seed=seed)
    b = lbfgs_run(data, LR_CHECK_STEPS, seed=seed)
    require(np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
            and np.array_equal(a[1].view(np.int32), b[1].view(np.int32)),
            "two card trainings give bitwise-equal coefficients and loss "
            "curves")
    # float64 on the card against the same run on the CPU
    d64 = {"fb_idx": fb, "y": y.astype(np.float64),
           "w": np.ones(LR_ROWS, np.float64)}
    gc, gl, _, _ = lbfgs_run(d64, LR_CHECK_STEPS, seed=seed)
    cc, cl, _, cpu_s = lbfgs_run(d64, LR_CHECK_STEPS, device="cpu",
                                 seed=seed)
    gap = np.abs(gl - cl) / np.abs(cl)
    cgap = np.abs(gc - cc)
    require(bool((gap <= 1e-10).all()),
            f"the float64 card run's loss curve within rtol 1e-10 of the "
            f"CPU's over {LR_CHECK_STEPS} supersteps (max rel {gap.max()})")
    out.update(two_runs_bitwise=True, card_vs_cpu_f64={
        "supersteps": LR_CHECK_STEPS, "loss_max_rel_gap": float(gap.max()),
        "coef_max_abs_gap": float(cgap.max()),
        "coef_max_abs": float(np.abs(cc).max()), "cpu_s": cpu_s})
    print(f"lbfgs: {n_conv} supersteps to converge at epsilon 1e-6; two "
          f"card runs bitwise; float64 card vs CPU over {LR_CHECK_STEPS} "
          f"supersteps: loss max rel gap {gap.max()}, coef max abs gap "
          f"{cgap.max()}", flush=True)
    return out


def host_auc(mapper, table, labels):
    s = mapper.predict_scores(table)
    return rank_auc(labels, s), s


def phase_lr_main(kl, ks, kf):
    """12(c): the main path chained on the card: batch LR on padded-COO
    Criteo rows -> its model table warm-starts FTRL -> the snapshot served
    by ``CompiledPredictor``."""
    import torch
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.types import TableSchema
    from alink_tpu_torch.operator.base import StreamOperator  # noqa: F401
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    from alink_tpu_torch.serving import CompiledPredictor
    t0 = time.perf_counter()
    train = criteo_ftrl_rows(3, LR_MAIN_ROWS)
    stream = criteo_ftrl_rows(4, 2 * FTRL_BATCH)
    held = criteo_ftrl_rows(5, LR_HELD_ROWS)
    y_held = np.asarray(held.col("label"))
    req = held.select(["vec"])
    out = {"rows": LR_MAIN_ROWS, "features": FEATURES,
           "data_s": time.perf_counter() - t0}
    ks.reset_launch_counts()
    kl.reset_launch_counts()
    kf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", l2=LR_L2).link_from(
        MemSourceBatchOp(train))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    train_launches = {**ks.launch_counts(), **kl.launch_counts()}
    model = lr.get_output_table()
    info = lr.get_side_output(0).get_output_table()
    curve = np.asarray(info.col("loss"))
    require(np.isfinite(curve).all() and curve[-1] < curve[0],
            "the L-BFGS loss fell")
    m = LinearModelDataConverter.load_table(model)
    require(m.coef.shape == (FEATURES + 1,) and np.isfinite(m.coef).all(),
            "finite L-BFGS coefficients over 2^20 features + intercept")
    warm = MemSourceBatchOp(model)
    ftrl = ftrl_op(warm, "sample", time_interval=2.0).link_from(
        MemSourceStreamOp(stream, batch_size=FTRL_BATCH))
    snaps = list(ftrl.timed_batches())
    require([t for t, _ in snaps] == [2.0], f"one snapshot after 2 "
            f"micro-batches: {[t for t, _ in snaps]}")
    snap = snaps[-1][1]
    mapper = LinearModelMapper(model.schema, TableSchema(["vec"], ["VECTOR"]),
                               Params({"prediction_col": "pred",
                                       "vector_col": "vec"}))
    mapper.load_model(model)
    gpu = CompiledPredictor(mapper)
    served = {}
    for name, table in (("lbfgs", model), ("ftrl", snap)):
        if name == "ftrl":
            gpu.swap_model(table)
        s_host, band = served_labels_match(gpu, req, table, name)
        served[name] = {"held_out_auc": rank_auc(y_held, s_host),
                        "rows_in_rounding_band": band}
    torch.cuda.synchronize()
    launches = {**ks.launch_counts(), **kl.launch_counts(),
                **kf.launch_counts()}
    for k in ("linear_grad", "serve_sparse", "ftrl_gather_pair",
              "ftrl_walk", "ftrl_scatter_add"):
        require(launches[k] > 0, f"the chained main path launched {k}: "
                                 f"{launches}")
    out.update(supersteps=len(curve), loss_first=float(curve[0]),
               loss_last=float(curve[-1]), training_launches=train_launches,
               main_path_launches=launches, served=served,
               ftrl_progressive_logloss=ftrl.progressive_logloss())
    print(f"lr main path: {LR_MAIN_ROWS} rows, {len(curve)} supersteps in "
          f"{out['train_s']:.3f} s, held-out AUC L-BFGS "
          f"{served['lbfgs']['held_out_auc']} FTRL snapshot "
          f"{served['ftrl']['held_out_auc']}, launches {launches}",
          flush=True)
    return out


BAD_SLOT_PROBE = """
import sys, torch
from alink_tpu_torch.kernels import ftrl as kf
st = torch.zeros(1 << 20, device="cuda")
ix = torch.tensor([3, 1 << 20, 5], dtype=torch.int32, device="cuda")
try:
    if sys.argv[1] == "gather":
        kf.gather_rows(st, ix)
    elif sys.argv[1] == "gather_pair":
        kf.gather_pair(st, st, ix)
    elif sys.argv[1] == "scatter":
        kf.scatter_add_rows(st, ix, torch.ones(3, device="cuda"))
    elif sys.argv[1] == "run_plan":
        from alink_tpu_torch.kernels import linear as kl
        kl.run_plan(ix.view(1, 3), 1 << 20)
    else:
        from alink_tpu_torch.kernels import tree_hist as kh
        kh.level_hist(torch.tensor([[1], [64], [2]], dtype=torch.int32,
                                   device="cuda"),
                      torch.ones((3, 3), device="cuda"),
                      torch.zeros(3, dtype=torch.int32, device="cuda"), 1, 64)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def phase_bad_slots():
    """An out-of-range slot (or bin) fails the kernel's device-side
    assert and the caller's stream raises at its synchronize. Each probe
    runs in a process of its own, since the assert ends that process's
    CUDA context; all start together."""
    root = str(Path(__file__).resolve().parent)
    procs = {k: subprocess.Popen([sys.executable, "-c", BAD_SLOT_PROBE, k],
                                 cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k in ("gather", "gather_pair", "scatter", "run_plan",
                       "tree_hist")}
    out = {}
    for k, p in procs.items():
        try:
            log, _ = p.communicate(timeout=120)
        finally:
            p.kill()
        said = [ln for ln in log.splitlines() if ln.startswith("raised:")]
        require(p.returncode == 0 and len(said) == 1,
                f"an out-of-range index in {k} raised on the card "
                f"(exit {p.returncode}): {log.strip()[-2000:]}")
        out[k] = said[0]
    return out


# ---------------------------------------------------------------------------
# the FTRLExample loop: feature pipeline -> LR warm start -> split stream ->
# FTRL -> hot-reloading predict -> windowed eval -> JSON values
# ---------------------------------------------------------------------------

# the reference's FTRLExample.java (Alink examples module): avazu's schema,
# its selected, categorical and numeric columns, its settings
EX_SCHEMA = ("id STRING, click STRING, dt STRING, C1 STRING, "
             "banner_pos INT, site_id STRING, site_domain STRING, "
             "site_category STRING, app_id STRING, app_domain STRING, "
             "app_category STRING, device_id STRING, device_ip STRING, "
             "device_model STRING, device_type STRING, "
             "device_conn_type STRING, "
             + ", ".join(f"C{k} INT" for k in range(14, 22)))
EX_CAT = ["C1", "banner_pos", "site_category", "app_domain", "app_category",
          "device_type", "device_conn_type", "site_id", "site_domain",
          "device_id", "device_model"]
EX_NUM = [f"C{k}" for k in range(14, 22)]
EX_SEL = (["C1", "banner_pos", "site_category", "app_domain",
           "app_category", "device_type", "device_conn_type"] + EX_NUM
          + ["site_id", "site_domain", "device_id", "device_model"])
EX_FEATURES, EX_LR_ITER, EX_INTERVAL = 30_000, 10, 10.0
EX_FTRL = dict(alpha=0.1, beta=0.1, l1=0.01, l2=0.01,
               time_interval=EX_INTERVAL, vector_size=EX_FEATURES)
EX_BATCH_ROWS, EX_STREAM_ROWS, EX_MICRO = 100_000, 262_144, 8192
# the float64 card-against-CPU pair runs the first 16 micro-batches (one
# interval snapshot and the final one, two windows): the CPU's plain
# FTRL step takes about a minute a 65,536 training rows
EX_CHECK_ROWS = 16 * EX_MICRO
# vocabulary sizes of avazu's order (its train file: 7 C1 values, 26 site
# categories, 4,737 site ids, 2.7 M device ids, 6.7 M device ips, ...),
# the device id and ip cut to hundreds of thousands
EX_VOCAB = {"C1": 7, "site_id": 4737, "site_domain": 7745,
            "site_category": 26, "app_id": 8552, "app_domain": 559,
            "app_category": 36, "device_id": 200_000, "device_ip": 400_000,
            "device_model": 8251, "device_type": 5, "device_conn_type": 4}
EX_INT_VALUES = {"banner_pos": [0, 1, 2, 3, 4, 5, 7],
                 "C15": [320, 300, 216, 728, 120, 1024, 480, 768],
                 "C16": [50, 250, 36, 480, 90, 20, 320, 768, 1024],
                 "C18": [0, 3, 2, 1]}
EX_INT_RANGES = {"C14": (375, 24053, 2626), "C17": (112, 2759, 435),
                 "C19": (33, 1960, 68), "C20": (100_000, 100_249, 172),
                 "C21": (1, 256, 60)}
# the true model's columns and the scale of their per-value effects
EX_TRUTH = {"site_id": 0.8, "app_id": 0.8, "device_model": 0.5,
            "banner_pos": 0.4, "C1": 0.3, "device_type": 0.3,
            "device_conn_type": 0.3, "site_category": 0.4, "C18": 0.3}
EX_BIAS = -2.2


def _zipf(rng, n, size, s=1.1):
    """Zipf-skewed draws of ``n`` indices into ``size`` values."""
    cdf = np.cumsum(1.0 / np.arange(1, size + 1) ** s)
    return np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(n)),
                      size - 1)


def avazu_world(seed):
    """The vocabularies and the true logistic model, from the seed."""
    rng = np.random.default_rng(seed)
    vocab = {}
    for col, size in EX_VOCAB.items():
        if col == "C1":
            vocab[col] = np.array([str(v) for v in (
                1005, 1002, 1010, 1012, 1007, 1001, 1008)], object)
        else:
            vocab[col] = np.array([f"{v:08x}" for v in rng.integers(
                0, 1 << 32, size)], object)
    for col, values in EX_INT_VALUES.items():
        vocab[col] = np.asarray(values, np.int64)
    for col, (lo, hi, size) in EX_INT_RANGES.items():
        vocab[col] = np.sort(rng.choice(np.arange(lo, hi), size, False))
    truth = {col: rng.standard_normal(len(vocab[col])) * scale
             for col, scale in EX_TRUTH.items()}
    # a site's domain and an app's domain follow the id, as in avazu
    domain_of = {"site_domain": rng.integers(0, EX_VOCAB["site_domain"],
                                             EX_VOCAB["site_id"]),
                 "app_domain": _zipf(rng, EX_VOCAB["app_id"],
                                     EX_VOCAB["app_domain"])}
    return vocab, truth, domain_of


def avazu_rows(world, seed, n, id_base=0):
    """``n`` avazu-shaped rows (``EX_SCHEMA``), Zipf-skewed over the
    world's vocabularies; clicks drawn from the logistic of the true
    model. Returns the table and the true logits."""
    from alink_tpu_torch.common.mtable import MTable
    vocab, truth, domain_of = world
    rng = np.random.default_rng(seed)
    ix = {col: _zipf(rng, n, len(v)) for col, v in vocab.items()
          if col not in domain_of}
    ix["site_domain"] = domain_of["site_domain"][ix["site_id"]]
    ix["app_domain"] = domain_of["app_domain"][ix["app_id"]]
    logit = EX_BIAS + sum(w[ix[col]] for col, w in truth.items())
    y = rng.random(n) < 1.0 / (1.0 + np.exp(-logit))
    cols = {"id": np.array([str(10_000_000_000 + id_base + i)
                            for i in range(n)], object),
            "click": np.where(y, "1", "0").astype(object),
            "dt": np.array([f"141021{h:02d}" for h in
                            rng.integers(0, 24, n)], object)}
    for name in EX_SCHEMA.split(", "):
        col = name.split()[0]
        if col not in cols:
            cols[col] = vocab[col][ix[col]]
    return MTable(cols, EX_SCHEMA), logit


def example_data(seed):
    world = avazu_world(seed)
    batch, _ = avazu_rows(world, seed + 1, EX_BATCH_ROWS)
    stream, logit = avazu_rows(world, seed + 2, EX_STREAM_ROWS,
                               id_base=EX_BATCH_ROWS)
    return batch, stream, logit


def example_pipeline(batch_data, path):
    """The feature pipeline, fit and saved, then loaded back; its
    seconds."""
    from alink_tpu_torch.pipeline import Pipeline, PipelineModel
    from alink_tpu_torch.pipeline.feature import FeatureHasher, StandardScaler
    t0 = time.perf_counter()
    fitted = Pipeline(
        StandardScaler(selected_cols=EX_NUM),
        FeatureHasher(selected_cols=EX_SEL, categorical_cols=EX_CAT,
                      output_col="vec", num_features=EX_FEATURES,
                      reserved_cols=["click"])).fit(batch_data)
    t1 = time.perf_counter()
    fitted.save(path)
    loaded = PipelineModel.load(path)
    t2 = time.perf_counter()
    return loaded, {"fit_s": t1 - t0, "save_load_s": t2 - t1}


def example_loop(data, loaded, device, dtype, profile=False):
    """The FTRLExample loop through the port's entry points: the loaded
    pipeline's features -> ``LogisticRegressionTrainBatchOp`` (the warm
    start) -> ``SplitStreamOp`` -> ``transform_stream`` of both halves ->
    ``FtrlTrainStreamOp`` -> ``FtrlPredictStreamOp`` (hot reload) ->
    ``EvalBinaryClassStreamOp`` -> ``JsonValueStreamOp`` ->
    ``CollectSinkStreamOp`` -> ``StreamOperator.execute()``. Returns the
    warm start's table, the snapshots (taps on the model stream), the
    sink's rows and the stage seconds."""
    import torch
    from alink_tpu_torch.operator.base import StreamOperator
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream.core import FnStreamOp
    from alink_tpu_torch.operator.stream.dataproc import SplitStreamOp
    from alink_tpu_torch.operator.stream.dataproc.format import \
        JsonValueStreamOp
    from alink_tpu_torch.operator.stream.evaluation import \
        EvalBinaryClassStreamOp
    from alink_tpu_torch.operator.stream.onlinelearning import (
        FtrlPredictStreamOp, FtrlTrainStreamOp)
    from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    batch, stream = data
    out = {}
    t0 = time.perf_counter()
    feats = loaded.transform(MemSourceBatchOp(batch))
    out["transform_s"] = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    lr = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="click", with_intercept=True,
        max_iter=EX_LR_ITER, device=device, dtype=dtype).link_from(feats)
    sync()
    out["lr_s"] = time.perf_counter() - t0
    out["supersteps"] = lr.get_side_output(0).get_output_table().num_rows
    split = SplitStreamOp(fraction=0.5).link_from(
        MemSourceStreamOp(stream, batch_size=EX_MICRO))
    ftrl = FtrlTrainStreamOp(
        lr, vector_col="vec", label_col="click", with_intercept=True,
        device=device, ship_dtype=dtype, **EX_FTRL).link_from(
        loaded.transform_stream(split))
    snaps = []
    tap = FnStreamOp(lambda mt: snaps.append(mt) or mt).link_from(ftrl)
    pred = FtrlPredictStreamOp(
        lr, vector_col="vec", prediction_col="pred",
        prediction_detail_col="details", reserved_cols=["click"]).link_from(
        tap, loaded.transform_stream(split.get_side_stream()))
    ev = EvalBinaryClassStreamOp(label_col="click",
                                 prediction_detail_col="details",
                                 time_interval=EX_INTERVAL).link_from(pred)
    vals = JsonValueStreamOp(
        selected_col="Data", output_cols=["Accuracy", "AUC",
                                          "ConfusionMatrix"],
        json_path=["$.Accuracy", "$.AUC", "$.ConfusionMatrix"]).link_from(ev)
    sink = CollectSinkStreamOp().link_from(vals)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    sync()
    t0 = time.perf_counter()
    StreamOperator.execute()
    sync()
    out["drain_s"] = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        busy_us = sum(float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0)))
                      for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA"))
        out["device_busy_s"] = busy_us / 1e6
        out["device_busy_share"] = busy_us / 1e6 / out["drain_s"]
    out["trainer"] = ftrl.trainer
    return lr.get_output_table(), snaps, sink.get_and_remove_values(), out


def example_host_only(data, loaded):
    """Source -> split -> the pipeline's ``transform_stream`` on both
    halves, consumed, without the FTRL or predict legs: the host's
    ceiling. Returns the seconds, the training half's micro-batch sizes,
    its first micro-batch and the evaluation half's last window."""
    from alink_tpu_torch.operator.stream.dataproc import SplitStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    split = SplitStreamOp(fraction=0.5).link_from(
        MemSourceStreamOp(data[1], batch_size=EX_MICRO))
    last_start = (EX_STREAM_ROWS // EX_MICRO - 1) // int(EX_INTERVAL) \
        * EX_INTERVAL
    t0 = time.perf_counter()
    sizes, first, last = [], None, None
    for _, mt in loaded.transform_stream(split).timed_batches():
        sizes.append(mt.num_rows)
        first = mt if first is None else first
    for t, mt in loaded.transform_stream(
            split.get_side_stream()).timed_batches():
        if t >= last_start:
            last = mt if last is None else last.concat_rows(mt)
    return time.perf_counter() - t0, sizes, first, last


def example_eval_leg(data, loaded, warm):
    """The loop's evaluation leg alone: source -> split -> the other
    half's ``transform_stream`` -> ``FtrlPredictStreamOp`` scoring with
    the warm start (an empty model stream) -> the windowed eval -> JSON
    values, drained by ``StreamOperator.execute()``; its seconds."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.base import StreamOperator
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream.dataproc import SplitStreamOp
    from alink_tpu_torch.operator.stream.dataproc.format import \
        JsonValueStreamOp
    from alink_tpu_torch.operator.stream.evaluation import \
        EvalBinaryClassStreamOp
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlPredictStreamOp
    from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    split = SplitStreamOp(fraction=0.5).link_from(
        MemSourceStreamOp(data[1], batch_size=EX_MICRO))
    lr = MemSourceBatchOp(warm)
    pred = FtrlPredictStreamOp(
        lr, vector_col="vec", prediction_col="pred",
        prediction_detail_col="details", reserved_cols=["click"]).link_from(
        MemSourceStreamOp(MTable([], warm.schema)),
        loaded.transform_stream(split.get_side_stream()))
    ev = EvalBinaryClassStreamOp(label_col="click",
                                 prediction_detail_col="details",
                                 time_interval=EX_INTERVAL).link_from(pred)
    sink = CollectSinkStreamOp().link_from(JsonValueStreamOp(
        selected_col="Data", output_cols=["AUC"],
        json_path=["$.AUC"]).link_from(ev))
    t0 = time.perf_counter()
    StreamOperator.execute()
    secs = time.perf_counter() - t0
    require(sink.get_and_remove_values().num_rows > 0,
            "the evaluation leg emitted eval rows")
    return secs


def _coefs(table):
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    return LinearModelDataConverter.load_table(table).coef


def _eval_rows(sink):
    return [(s, json.loads(d)) for s, d in zip(sink.col("Statistics"),
                                                sink.col("Data"))]


def phase_example(kernels, seed, card):
    """13: the FTRLExample loop on the card at 30,000 hashed features;
    ``kernels`` are the kernel modules, whose launch counts the float32
    run reads."""
    import torch
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionPredictBatchOp
    from alink_tpu_torch.operator.batch.evaluation.eval_ops import \
        parse_detail_probs
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.evaluation.metrics import \
        binary_metrics
    tag = f"[{card}]"
    t0 = time.perf_counter()
    batch, stream, logit = example_data(seed)
    data = (batch, stream)
    y_stream = np.asarray(stream.col("click")) == "1"
    out = {"card": card, "batch_rows": EX_BATCH_ROWS,
           "stream_rows": EX_STREAM_ROWS, "micro_batch": EX_MICRO,
           "features": EX_FEATURES, "data_s": time.perf_counter() - t0,
           "click_rate": float(y_stream.mean()),
           "bayes_auc": rank_auc(y_stream.astype(np.int64), logit)}
    path = str(Path(__file__).resolve().parent / "build" / "ftrl_example"
               / "feature_pipeline.json")
    loaded, times = example_pipeline(MemSourceBatchOp(batch), path)
    out.update(times)
    print(f"ftrl example {tag}: {EX_BATCH_ROWS} batch rows, "
          f"{EX_STREAM_ROWS} stream rows, click rate "
          f"{out['click_rate']:.4f}, Bayes AUC {out['bayes_auc']}; "
          f"pipeline fit {times['fit_s']:.3f} s, save + load "
          f"{times['save_load_s']:.3f} s", flush=True)
    host_s, sizes, first, last = example_host_only(data, loaded)
    # the stage split from a second drain: the timer and the kept tokens
    # stay out of host_only_s
    with HashStages() as stages:
        staged_s = example_host_only(data, loaded)[0]
    out.update(host_only_s=host_s,
               host_only_rows_per_s=EX_STREAM_ROWS / host_s,
               train_rows=int(sum(sizes)), train_micro_batches=len(sizes),
               host=host_cpu(), host_only_stages_s=stages.split(staged_s),
               hash_in_turns=stages.hash_in_turns())
    print(f"ftrl example {tag} [{out['host']}]: host-only drain (source -> "
          f"split -> transform_stream on both halves) {host_s:.3f} s, "
          f"{EX_STREAM_ROWS / host_s:.1f} stream rows/s; a second drain's "
          f"stages (s) {out['host_only_stages_s']}; the hash in turns, "
          f"native vs numpy: {out['hash_in_turns']}", flush=True)
    # the float32 card run: launch counts, times, the busy share
    for k in kernels:
        k.reset_launch_counts()
    torch.cuda.synchronize()
    lr32, snaps32, rows32, run32 = example_loop(data, loaded, "cuda",
                                                torch.float32)
    counts = {name: c for k in kernels
              for name, c in k.launch_counts().items()}
    n = run32["supersteps"]
    chunks = sum(-(-max(sizes[0], r) // 4) for r in sizes)
    want = {"linear_grad": n, "serve_sparse": 2 * n,
            "ftrl_gather_pair": chunks, "ftrl_walk": chunks,
            "ftrl_scatter_add": 2 * chunks, "ftrl_gather": 0,
            "serve_dense": 0, "tree_hist": 0}
    got = {k: counts[k] for k in want}
    require(got == want, f"the loop's launches {got} are the design's "
                         f"{want}")
    out["launches"] = counts
    rows_s = EX_STREAM_ROWS / run32["drain_s"]
    out.update(lr_s=run32["lr_s"], supersteps=n,
               transform_s=run32["transform_s"], drain_s=run32["drain_s"],
               stream_rows_per_s=rows_s,
               ftrl_samples_per_s=out["train_rows"] / run32["drain_s"])
    print(f"ftrl example {tag}: LR {run32['lr_s']:.3f} s ({n} supersteps), "
          f"drain {run32['drain_s']:.3f} s, {rows_s:.1f} stream rows/s, "
          f"FTRL {out['ftrl_samples_per_s']:.1f} samples/s; launches "
          f"{got}", flush=True)
    # reproducible: a second float32 card run, under the profiler
    lr32b, snaps32b, rows32b, run32b = example_loop(
        data, loaded, "cuda", torch.float32, profile=True)
    require(np.array_equal(_coefs(lr32).view(np.int64),
                           _coefs(lr32b).view(np.int64))
            and len(snaps32) == len(snaps32b)
            and all(np.array_equal(_coefs(a).view(np.int64),
                                   _coefs(b).view(np.int64))
                    for a, b in zip(snaps32, snaps32b))
            and list(rows32.col("Data")) == list(rows32b.col("Data")),
            "two float32 card runs give bitwise-equal warm starts and "
            "snapshots and equal eval JSON")
    out.update(profiled_drain_s=run32b["drain_s"],
               device_busy_s=run32b.get("device_busy_s"),
               device_busy_share=run32b.get("device_busy_share"))
    out["stage_ms"] = dict(trainer_stages(run32["trainer"], first, 3)[0],
                           rows=first.num_rows)
    out["eval_leg_s"] = example_eval_leg(data, loaded, lr32)
    print(f"ftrl example {tag}: two float32 runs bitwise; card busy "
          f"{out['device_busy_s']} s of a {run32b['drain_s']:.3f} s "
          f"profiled drain (share {out['device_busy_share']}, a floor); "
          f"trainer stages of a {first.num_rows}-row micro-batch (ms): "
          f"{out['stage_ms']}; the evaluation leg alone (split, features, "
          f"warm-start scoring, eval, JSON) {out['eval_leg_s']:.3f} s",
          flush=True)
    # float64: the card against the CPU, on the stream's first
    # EX_CHECK_ROWS rows
    runs = {}
    check = (batch, stream.first_n(EX_CHECK_ROWS))
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = example_loop(check, loaded, dev, torch.float64)
        runs[dev][3]["wall_s"] = time.perf_counter() - t0
    (glr, gsn, grow, _), (clr, csn, crow, crun) = runs["cuda"], runs["cpu"]
    gaps = [np.abs(_coefs(glr) - _coefs(clr)) / np.abs(_coefs(clr)).clip(
        1e-300)]
    require(bool((gaps[0] <= 1e-10).all()),
            f"the float64 card warm start within rtol 1e-10 of the CPU's "
            f"(max {gaps[0].max()})")
    require(len(gsn) == len(csn) > 1,
            f"as many snapshots on the card as on the CPU: {len(gsn)}, "
            f"{len(csn)}")
    for a, b in zip(gsn, csn):
        gap = np.abs(_coefs(a) - _coefs(b)) / np.abs(_coefs(b)).clip(1e-300)
        require(bool((gap <= 1e-10).all()),
                f"a float64 card snapshot within rtol 1e-10 of the CPU's "
                f"(max {gap.max()})")
        gaps.append(gap)
    ge, ce = _eval_rows(grow), _eval_rows(crow)
    auc_gap = 0.0
    require(len(ge) == len(ce) and [s for s, _ in ge] == [s for s, _ in ce],
            "the same eval rows on the card and the CPU")
    for (s, a), (_, b) in zip(ge, ce):
        require(a["ConfusionMatrix"] == b["ConfusionMatrix"],
                f"eval {s} row: equal confusion matrices")
        if b["AUC"] is not None:
            auc_gap = max(auc_gap, abs(a["AUC"] - b["AUC"]))
    require(auc_gap <= 1e-6, f"eval AUC within 1e-6: {auc_gap}")
    out["card_vs_cpu_f64"] = {
        "coef_max_rel_gap": float(max(g.max() for g in gaps)),
        "auc_max_gap": auc_gap, "snapshots": len(gsn),
        "stream_rows": EX_CHECK_ROWS, "eval_rows": len(ge),
        "cpu_drain_s": crun["drain_s"], "cpu_lr_s": crun["lr_s"],
        "cpu_wall_s": crun["wall_s"]}
    # learns: the last window's AUC against the warm start's on its rows
    evals = _eval_rows(rows32)
    windows = [m.get("AUC") for s, m in evals if s == "window"]
    cumulative = [m.get("AUC") for s, m in evals if s == "all"]
    warm = LogisticRegressionPredictBatchOp(
        prediction_col="pred", prediction_detail_col="details",
        vector_col="vec").link_from(MemSourceBatchOp(lr32),
                                    MemSourceBatchOp(last))
    pos, p_pos = parse_detail_probs(warm.get_output_table().col("details"))
    warm_auc = binary_metrics(last.col("click"), p_pos, pos).get("AUC")
    require(windows[-1] is not None and windows[-1] > 0.6,
            f"the last window's AUC is above 0.6: {windows[-1]}")
    out.update(window_auc=windows, cumulative_auc=cumulative,
               warm_start_auc_last_window=warm_auc,
               last_window_rows=last.num_rows)
    print(f"ftrl example {tag}: float64 card vs CPU: coefficients max rel "
          f"gap {out['card_vs_cpu_f64']['coef_max_rel_gap']} over the warm "
          f"start and {len(gsn)} snapshots, AUC max gap {auc_gap} over "
          f"{len(ge)} eval rows ({EX_CHECK_ROWS} stream rows); CPU drain "
          f"{crun['drain_s']:.3f} s", flush=True)
    print(f"ftrl example {tag}: window AUC {windows}, cumulative "
          f"{cumulative}; the last window ({last.num_rows} rows): FTRL "
          f"{windows[-1]}, the warm start {warm_auc}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 14. FTRL's batch mode: the ordered scatter-add (P2), the batch and dense
#     steps, bench_ftrl's stream and DAG, the hooks
# ---------------------------------------------------------------------------

# bench.py::bench_ftrl's shapes: the padded-COO batch step (4096 rows of
# 39 one-hot slots and the intercept over 65,536 hashed features), the
# field-blocked one (40 fields of 1648, the intercept field first) and the
# stream (262,144 rows of site / dev / app hashed field-aware into 3 fields
# of 1648, 16,384-row micro-batches, a warm start of 3 L-BFGS supersteps on
# the first 4,096 rows); its hyperparameters are FTRL_HP
BF_ROWS, BF_DIM, BF_FIELDS, BF_S = 4096, 65_536 + 1, 40, 1648
ST_ROWS, ST_MICRO, ST_WARM_ROWS, ST_WARM_ITER = 262_144, 16_384, 4096, 3
# the dense steps: a dense-feature model of 256 columns (no bench shape);
# the strict one cut to 512-row micro-batches (about 35 small ops a sample)
DENSE_D, DENSE_STRICT_B = 256, 512
BATCH_STEP_CHECKS = 3                 # micro-batches of the f64 card vs CPU
# the field-blocked steps are float32 by the JAX package's semantics: the
# float64 card run holds the CPU's within this share of the largest change
# (tests/test_torch_ftrl_batch.py's FB_RTOL)
FB_RTOL = 1e-6
# each case with its kinds: the field-blocked step's use of the kernel
# (float32 terms into zeroed states) is float32 only. Those two cases draw
# from a generator of their own (SCATTER_USE_SEED), so the phase's shared
# generator reaches the steps of 14(b) in the state it had before they were
# added: the field-blocked steps' float64 card-vs-CPU gate depends on its
# data (see step_case)
SCATTER_CASES = tuple((c, ("f32", "f64")) for c in (
    "coo", "coo_2e20", "fb", "stream", "one", "same_slot", "negzero",
    "nan")) + (("fb_use", ("f32",)), ("stream_use", ("f32",)))
SCATTER_USE_SEED = 1411
SCATTER_TIMED = ("coo", "coo_2e20", "fb", "stream", "fb_use", "stream_use")


def scatter_inputs(rng, case, dtype):
    """(keys (B, w) int32, terms (B, w, 2), states (2, S)) of one case of
    the ordered scatter-add: the three batch shapes of ``bench_ftrl``
    (padded COO over 65,536 + 1 and 2^20 + 1 slots, the intercept in
    column 0; field-blocked over 40 x 1648; the stream's 16,384 x 4 over 3
    x 1648 + 1), the field-blocked step's use of the last two (states of
    zeros, ``*_use``) and edges: one update, every key one slot (a heavy
    run of 16,384), a state of ``-0.0`` wherever no key lands, NaN and inf
    terms."""
    if case.endswith("_use"):
        keys, terms, states = scatter_inputs(rng, case[:-4], dtype)
        return keys, terms, np.zeros_like(states)
    B, w, S = {"coo": (BF_ROWS, 40, BF_DIM),
               "coo_2e20": (BF_ROWS, 40, FEATURES + 1),
               "fb": (BF_ROWS, BF_FIELDS, BF_FIELDS * BF_S),
               "stream": (ST_MICRO, 4, 3 * BF_S + 1),
               "one": (1, 1, 7), "same_slot": (ST_MICRO, 1, BF_DIM),
               "negzero": (256, 40, BF_DIM), "nan": (256, 40, BF_DIM)}[case]
    if case == "fb":
        keys = (rng.integers(0, BF_S, (B, w))
                + np.arange(w) * BF_S).astype(np.int32)
        keys[:, 0] = 0
    elif case == "stream":
        keys = (rng.integers(0, BF_S, (B, w)) + 1
                + (np.arange(w) - 1) * BF_S).astype(np.int32)
        keys[:, 0] = 0
    elif case == "same_slot":
        keys = np.full((B, w), 7, np.int32)
    else:
        keys = rng.integers(1, S, (B, w)).astype(np.int32)
        keys[:, 0] = 0
    terms = rng.standard_normal((B, w, 2)).astype(dtype)
    states = rng.standard_normal((2, S)).astype(dtype)
    states[:, ::97] = -0.0
    if case == "negzero":
        states[:] = -0.0
    if case == "nan":
        terms[::7, 3, 0] = np.nan
        terms[::11, 0, 1] = np.inf
        terms[5, 0, 0] = -np.inf
    return keys, terms, states


def scatter_case(kl, rng, case, kind, lat):
    """The ordered scatter-add on the card against its plain version on
    the CPU (``scatter_add_rows_plain``), bitwise (a NaN equal to any
    NaN), both states in one launch. At the timed shapes: the kernel alone
    on a built plan (events, profiler, host), the plan over the touched
    slots (``run_plan``, the one both ordered kernels walk), the wrapper
    (plan and kernel), the plain version, two ``index_add_`` calls
    in turns (not deterministic; a yardstick), the bytes bound and the
    chain bound of the longest run (z's and n's chains side by side)."""
    import torch
    dtype = np.float32 if kind == "f32" else np.float64
    if case.endswith("_use"):
        rng = np.random.default_rng(SCATTER_USE_SEED)
    keys, terms, states = scatter_inputs(rng, case, dtype)
    dev = torch.device("cuda")
    kd, td = torch.from_numpy(keys).to(dev), torch.from_numpy(terms).to(dev)
    z, n = (torch.from_numpy(s.copy()).to(dev) for s in states)
    kl.scatter_walk(z, n, kd, td)
    zc, nc = (torch.from_numpy(s.copy()) for s in states)
    t0 = time.perf_counter()
    kl.scatter_walk_plain(zc, nc, torch.from_numpy(keys),
                          torch.from_numpy(terms))
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, raws = 0.0, []
    for got, want, name in ((z.cpu(), zc, "z"), (n.cpu(), nc, "n")):
        same, raw = same_bits(got, want)
        raws.append(raw)
        fin = torch.isfinite(want)
        if bool(fin.any()):
            err = max(err, float((got[fin].double()
                                  - want[fin].double()).abs().max()))
        require(same, f"scatter_walk {case} {kind} {name} bitwise vs its "
                      f"plain version (max abs err {err})")
    untouched = np.ones(states.shape[1], bool)
    untouched[keys.reshape(-1)] = False
    require(bool(torch.equal(bits(z.cpu()[torch.from_numpy(untouched)]),
                             bits(torch.from_numpy(states[0][untouched])))),
            f"scatter_walk {case} {kind}: untouched slots keep their bits")
    plan = kl.run_plan(kd, states.shape[1])
    host = kl.run_plan_plain(torch.from_numpy(keys), states.shape[1])
    require(plan_equal(kl, plan, host),
            f"scatter_walk {case} {kind}: the card's plan is the plain "
            f"one's")
    runs, n_heavy, n_medium, _ = kl.plan_counts(host)
    counts = np.unique(keys, return_counts=True)[1]
    rec = {"bitwise": True, "raw_bits_equal": all(raws), "max_abs_err": err,
           "plan_equal": True, "positions": int(keys.size),
           "slots": int(states.shape[1]), "runs": runs,
           "heavy_runs": n_heavy, "medium_runs": n_medium,
           "longest_run": int(counts.max())}
    if case not in SCATTER_TIMED:
        return rec
    M, U, isz = keys.size, runs, np.dtype(dtype).itemsize
    # the plan, the terms read once; z and n read and written at the runs
    b_ms, b_by = _bound(4 * M + 12 * U + 4 + 2 * M * isz + 4 * U * isz,
                        2 * M, kind)
    kl_ = kd.reshape(-1).long()
    tz, tn = td[..., 0].reshape(-1), td[..., 1].reshape(-1)
    call = lambda: kl.scatter_walk(z, n, kd, td, plan=plan)    # noqa: E731
    lib = lambda: (z.index_add_(0, kl_, tz),                    # noqa: E731
                   n.index_add_(0, kl_, tn))
    k_ms, l_ms = cuda_ms_turns(call, lib, trials=9, reps=5)
    k_host, l_host = host_ms_turns(call, lib, trials=9, reps=5)
    dev_ms, dev_seen = device_span_ms(call, "scatter_walk_")
    plan_fn = lambda: kl.run_plan(kd, states.shape[1])         # noqa: E731
    wrap_ms, plan_ms, plan_plain_ms = cuda_ms_turns(
        lambda: kl.scatter_walk(z, n, kd, td), plan_fn,
        lambda: kl.run_plan_plain(kd, states.shape[1]), trials=7, reps=5)
    plan_dev_ms, plan_kernels = device_ms(plan_fn)
    plan_host_ms = host_ms(plan_fn, trials=7, reps=5)
    # the plan's bound: the keys read once; perm, starts, slots, order and
    # the counts written once
    plan_b_ms, plan_b_by = _bound(4 * M + 4 * M + 12 * U + 4 + 16, 0, kind)
    chain_ms = chain_bound_ms(rec["longest_run"], kind, lat)
    rec.update(kernel_ms=k_ms, device_ms=dev_ms,
               device_launches_recorded=dev_seen, host_ms=k_host,
               wrapper_ms=wrap_ms, plan_ms=plan_ms,
               plan_device_ms=plan_dev_ms, plan_host_ms=plan_host_ms,
               plan_device_kernels=plan_kernels,
               plan_plain_ms=plan_plain_ms, plan_bound_ms=plan_b_ms,
               plan_bound_by=plan_b_by, plain_ms=plain_ms,
               plain_where="CPU", library_ms=l_ms,
               library_device_ms=device_ms(lib)[0], library_host_ms=l_host,
               library_deterministic=False, bound_ms=b_ms, bound_by=b_by,
               chain_bound_ms=chain_ms, chain_fraction=chain_ms / k_ms)
    return rec


def batch_gathers(kf, rng):
    """``gather_pair`` (the batch steps' gather of the touched slots)
    against its plain version, bitwise, f32 and f64, with its times, at
    the padded-COO batch shape (bench_ftrl's 4096 x 40, the intercept in
    column 0, over 65,536 + 1 and 2^20 + 1 slots) and at the stream's
    field-blocked one (16,384 x 4 over the intercept field and 3 fields
    of 1648)."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for name, (B, w, S, F) in {
            "coo": (BF_ROWS, 40, BF_DIM, 0),
            "coo_2e20": (BF_ROWS, 40, FEATURES + 1, 0),
            "stream_fb": (ST_MICRO, 4, 4 * BF_S, BF_S)}.items():
        if F:
            ix = rng.integers(0, F, (B, w)) + np.arange(w) * F
        else:
            ix = rng.integers(1, S, (B, w))
        ix[:, 0] = 0
        ix = torch.from_numpy(ix.reshape(-1).astype(np.int32)).to(dev)
        touched = int(torch.unique(ix).numel())
        for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
            st = torch.from_numpy(rng.standard_normal((S, 2))).to(dev, dtype)
            out[f"{name} {kind} M={B * w}"] = pair_shape(
                kf, st, ix, kind, 4 if kind == "f32" else 8, touched)
    return out


def batch_rows(rng, n):
    """``bench.py::make_batch_criteo``'s rows over BF_DIM slots, as the
    trainer takes them: 39 distinct one-hot slots of the hashed features
    (the trainer adds the intercept), labels from a seeded sparse true
    model (2 % of the features non-zero)."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    feats = BF_DIM - 1
    w_true = rng.standard_normal(feats) * (rng.random(feats) < 0.02)
    raw = np.argsort(rng.random((n, feats // 64)), axis=1)[:, :NNZ]
    raw = np.sort(raw * 64 + rng.integers(0, 64, (n, NNZ)), axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-w_true[raw].sum(1)))).astype(
        np.int64)
    vecs = np.empty(n, object)
    ones = np.ones(NNZ)
    vecs[:] = [SparseVector(feats, raw[i], ones) for i in range(n)]
    return MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


def step_inputs(rng, kind, b, dtype):
    """One micro-batch of each step's device input, as numpy: ``coo``
    (idx, val, y) at bench_ftrl's batch shape, ``fb`` (fb_idx int16, val
    or None, y) over 40 x 1648, ``fb_val`` the same with values, ``dense``
    (X, y) of DENSE_D columns and the intercept."""
    y = (rng.random(b) < 0.3).astype(dtype)
    if kind == "coo":
        idx = np.zeros((b, 40), np.int32)
        idx[:, 1:] = np.sort(np.argsort(rng.random((b, (BF_DIM - 1) // 64)),
                                        axis=1)[:, :NNZ] * 64
                             + rng.integers(1, 64, (b, NNZ)), axis=1)
        return idx, np.ones((b, 40), dtype), y
    if kind in ("fb", "fb_val"):
        fbi = rng.integers(0, BF_S, (b, BF_FIELDS)).astype(np.int16)
        fbi[:, 0] = 0
        val = None if kind == "fb" else np.round(
            rng.random((b, BF_FIELDS)) * 2, 2).astype(dtype)
        return fbi, val, y
    X = rng.standard_normal((b, DENSE_D + 1)).astype(dtype)
    X[:, 0] = 1.0
    return X, y


STEP_KINDS = ("coo", "fb", "fb_val", "dense", "dense_strict")


def run_steps(tf, kind, batches, z0, n0, device, dtype):
    """``batches`` micro-batches of one step from ``(z0, n0)`` on
    ``device`` in ``dtype``: (z, n, margins of every micro-batch)."""
    import torch
    from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
    hp = (FTRL_HP["alpha"], FTRL_HP["beta"], FTRL_HP["l1"], FTRL_HP["l2"])
    # copies: the padded-COO step updates the state in place
    z = torch.tensor(z0, device=device, dtype=dtype)
    n = torch.tensor(n0, device=device, dtype=dtype)
    margins = []
    for arrays in batches:
        t = [None if a is None else torch.from_numpy(a).to(device)
             for a in arrays]
        t = [a.to(dtype) if a is not None and a.is_floating_point()
             else a for a in t]
        if kind == "coo":
            z, n, m = tf.ftrl_batch_step(*t, z, n, *hp)
        elif kind.startswith("fb"):
            z, n, m = tf.ftrl_fb_batch_step(
                *t, z, n, FieldBlockMeta(BF_FIELDS, BF_S), *hp)
        elif kind == "dense":
            z, n, m = tf.ftrl_dense_batch_step(*t, z, n, *hp)
        else:
            z, n, m = tf.ftrl_dense_step(*t, z, n, *hp)
        margins.append(m)
    return (z.cpu().numpy(), n.cpu().numpy(),
            torch.cat(margins).cpu().numpy())


def step_case(tf, kl, kf, rng, kind):
    """One step on the card: float64 within rtol 1e-10 (+1e-12 abs) of
    the CPU on z, n and the margins over BATCH_STEP_CHECKS micro-batches
    (2 for the strict dense step; the field-blocked steps, float32 inside,
    within FB_RTOL of the largest change: a bound that holds for some data
    only, since on other data the CPU run alone, its margins perturbed in
    their last bits, moves the intercept's z by more), two float32 runs
    bitwise, the
    launches of one micro-batch, its ms alone (each ending in a synchronize) and
    samples/s, and the card's busy share under one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b = DENSE_STRICT_B if kind == "dense_strict" else BF_ROWS
    size = {"coo": BF_DIM, "fb": BF_FIELDS * BF_S,
            "fb_val": BF_FIELDS * BF_S}.get(kind, DENSE_D + 1)
    checks = 2 if kind == "dense_strict" else BATCH_STEP_CHECKS
    src = "dense" if kind.startswith("dense") else kind
    batches = [step_inputs(rng, src, b, np.float64) for _ in range(checks)]
    z0 = rng.standard_normal(size) * 0.01
    n0 = np.abs(rng.standard_normal(size)) * 0.01
    card = run_steps(tf, kind, batches, z0, n0, "cuda", torch.float64)
    cpu = run_steps(tf, kind, batches, z0, n0, "cpu", torch.float64)
    errs = {}
    for name, a, w, base in zip(("z", "n", "margins"), card, cpu,
                                (z0, n0, 0.0)):
        require(bool(np.isfinite(a).all()), f"{kind} step {name} finite")
        gap = np.abs(a - w)
        if kind.startswith("fb"):
            # float32 arithmetic (the JAX package's): within FB_RTOL of
            # the largest delta (or margin)
            scale = float(np.abs(w - base).max())
            ok = float(gap.max()) <= FB_RTOL * scale
            what = f"within {FB_RTOL} of its largest change {scale}"
        else:
            ok = bool((gap <= 1e-10 * np.abs(w) + 1e-12).all())
            what = "within rtol 1e-10"
        require(ok, f"{kind} step: card {name} {what} of the CPU (max abs "
                    f"err {gap.max()})")
        errs[name] = float(gap.max())
    f32 = [run_steps(tf, kind, batches, z0, n0, "cuda", torch.float32)
           for _ in range(2)]
    require(all(np.array_equal(a.view(np.int32), w.view(np.int32))
                for a, w in zip(*f32)),
            f"{kind} step: two float32 card runs bitwise")
    # one micro-batch alone: launches, ms, busy share
    z = torch.from_numpy(z0).cuda().float()
    n = torch.from_numpy(n0).cuda().float()
    t = [None if a is None else torch.from_numpy(a).cuda() for a in
         batches[0]]
    t = [a.float() if a is not None and a.is_floating_point() else a
         for a in t]
    hp = tuple(FTRL_HP[k] for k in ("alpha", "beta", "l1", "l2"))

    def one():
        if kind == "coo":
            return tf.ftrl_batch_step(*t, z, n, *hp)
        if kind.startswith("fb"):
            from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
            return tf.ftrl_fb_batch_step(
                *t, z, n, FieldBlockMeta(BF_FIELDS, BF_S), *hp)
        if kind == "dense":
            return tf.ftrl_dense_batch_step(*t, z, n, *hp)
        return tf.ftrl_dense_step(*t, z, n, *hp)
    one()
    no_wait = kind in ("coo", "fb", "fb_val")
    if no_wait:
        # the sparse batch steps issue no call that waits on the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for k in (kl, kf):
        k.reset_launch_counts()
    one()
    torch.cuda.synchronize()
    launches = {k: v for m in (kl, kf) for k, v in m.launch_counts().items()
                if v}
    times = []
    for _ in range(3 if kind == "dense_strict" else 9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    busy_us, device_ops = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy_us += float(getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)))
            device_ops += int(e.count)
    return {"rows": b, "check_micro_batches": checks,
            "f64_card_vs_cpu_max_abs_err": errs, "f32_runs_bitwise": True,
            "ran_under_sync_debug_error": no_wait,
            "launches_per_micro_batch": launches,
            "device_ops_per_micro_batch": device_ops, "step_ms": step_ms,
            "samples_per_s": b / step_ms * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / step_ms if busy_us else None}


def batch_main_path(kl, kf, rng):
    """The COO batch step's main path through the entry point:
    ``FtrlTrainStreamOp(update_mode="batch")`` on bench_ftrl's Criteo-shape
    rows (4096-row micro-batches over 65,536 + 1 slots, 6 of them, a
    snapshot every 2), counts set to 0 just before and read just after:
    one ``gather_pair``, one plan and one ordered scatter-add a
    micro-batch, nothing else of the package."""
    import torch
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlTrainStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    micro = 6
    rows = batch_rows(rng, micro * BF_ROWS)
    coef = rng.standard_normal(BF_DIM) * 0.01
    warm = MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(coef, has_intercept=True, label_values=[1, 0],
                                vector_col="vec", vector_size=BF_DIM - 1,
                                label_type="LONG")))
    op = FtrlTrainStreamOp(warm, vector_col="vec", label_col="label",
                           update_mode="batch", time_interval=2.0,
                           **FTRL_HP).link_from(
        MemSourceStreamOp(rows, batch_size=BF_ROWS))
    for k in (kl, kf):
        k.reset_launch_counts()
    snaps, secs = drain_timed(op)
    counts = {k: v for m in (kl, kf) for k, v in m.launch_counts().items()}
    want = dict({k: 0 for k in counts}, ftrl_gather_pair=micro,
                run_plan=micro, scatter_walk=micro)
    require(counts == want,
            f"the batch main path launched {counts}: one gather_pair, one "
            f"run_plan and one scatter_walk a micro-batch and nothing else")
    require(len(snaps) == 3 and all(np.isfinite(_coefs(s)).all()
                                    for _, s in snaps),
            "the batch main path's snapshots are finite")
    pl = op.progressive_logloss()
    require(len(pl) == micro and all(np.isfinite(v) for _, v in pl),
            "progressive log loss of every micro-batch")
    return {"micro_batches": micro, "rows": micro * BF_ROWS,
            "drain_s": secs, "samples_per_s": micro * BF_ROWS / secs,
            "main_path_launches": counts,
            "progressive_logloss": [v for _, v in pl]}


def bench_stream_data():
    """bench.py::bench_ftrl's stream (bench.py:1044-1061): 262,144 rows of
    site / dev / app from ``RandomState(17)``, the click's rate by the
    site's parity."""
    from alink_tpu_torch.common.mtable import MTable
    srng = np.random.RandomState(17)
    site_ids = srng.randint(0, 4000, ST_ROWS)
    sites = np.char.add("s", site_ids.astype("U6"))
    devs = np.char.add("d", srng.randint(0, 4000, ST_ROWS).astype("U6"))
    apps = np.char.add("a", srng.randint(0, 4000, ST_ROWS).astype("U6"))
    ys = (srng.rand(ST_ROWS) < 0.1 + 0.8 * (site_ids % 2)).astype(np.int64)
    cols = {"site": sites.astype(object), "dev": devs.astype(object),
            "app": apps.astype(object), "click": ys}
    return MTable(cols, "site STRING, dev STRING, app STRING, click LONG")


ST_HASH = dict(selected_cols=["site", "dev", "app"],
               categorical_cols=["site", "dev", "app"], output_col="vec",
               num_features=3 * BF_S, field_aware=True)


def bench_stream(kl, kf, table):
    """bench_ftrl's drain_stream, drain_host_only and drain_full_dag on the
    port, float32 on the card, each timed after a warm run as bench.py
    times them; then the trainer's stages on one micro-batch and the
    card's busy share under a profiled drain."""
    import json as _json
    import torch
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.feature.feature_ops import \
        FeatureHasherBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp
    from alink_tpu_torch.operator.stream.evaluation import \
        EvalBinaryClassStreamOp
    from alink_tpu_torch.operator.stream.onlinelearning import (
        FtrlPredictStreamOp, FtrlTrainStreamOp)
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    t0 = time.perf_counter()
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="click",
        max_iter=ST_WARM_ITER).link_from(FeatureHasherBatchOp(
            **ST_HASH).link_from(MemSourceBatchOp(
                table.first_n(ST_WARM_ROWS))))
    warm.get_output_table()
    out = {"warm_start_s": time.perf_counter() - t0}

    def train_op(interval, time_per_batch=None):
        kw = {} if time_per_batch is None else {
            "time_per_batch": time_per_batch}
        src = MemSourceStreamOp(table, batch_size=ST_MICRO, **kw)
        feat = FeatureHasherStreamOp(**ST_HASH).link_from(src)
        return feat, FtrlTrainStreamOp(
            warm, vector_col="vec", label_col="click", update_mode="batch",
            time_interval=interval, **FTRL_HP).link_from(feat)

    def drain_stream():
        _, ftrl = train_op(1e9)
        last = None
        for mt in ftrl.micro_batches():
            last = mt
        torch.cuda.synchronize()
        return ftrl, last

    def drain_host_only():
        src = MemSourceStreamOp(table, batch_size=ST_MICRO)
        feat = FeatureHasherStreamOp(**ST_HASH).link_from(src)
        return sum(mt.num_rows for _, mt in feat.timed_batches())

    def drain_full_dag():
        feat, ftrl = train_op(4.0, time_per_batch=1.0)
        pred = FtrlPredictStreamOp(
            warm, vector_col="vec", prediction_col="pred",
            prediction_detail_col="details").link_from(ftrl, feat)
        ev = EvalBinaryClassStreamOp(
            label_col="click", prediction_detail_col="details",
            time_interval=4.0).link_from(pred)
        last_auc, rows = float("nan"), 0
        for _, mt in ev.timed_batches():
            for s_, d in zip(mt.col("Statistics"), mt.col("Data")):
                if str(s_) == "window":
                    v = _json.loads(d).get("AUC")
                    last_auc = last_auc if v is None else float(v)
            rows += 1
        require(rows > 0, "the DAG's eval stream has rows")
        return last_auc

    drain_stream()                                    # warm
    for k in (kl, kf):
        k.reset_launch_counts()
    t0 = time.perf_counter()
    ftrl, last = drain_stream()
    out["stream_s"] = time.perf_counter() - t0
    counts = {k: v for m in (kl, kf) for k, v in m.launch_counts().items()}
    micro = ST_ROWS // ST_MICRO
    require(counts["scatter_walk"] == micro
            and counts["run_plan"] == micro
            and counts["ftrl_gather_pair"] == micro
            and counts["linear_grad"] == 0,
            f"the stream ran the field-blocked program every micro-batch: "
            f"one plan and one scatter_walk, no linear_grad (launches "
            f"{counts})")
    require(bool(np.isfinite(_coefs(last)).all()), "the stream's model "
                                                   "is finite")
    out.update(stream_rows_per_s=ST_ROWS / out["stream_s"],
               stream_launches=counts)
    t0 = time.perf_counter()
    require(drain_host_only() == ST_ROWS, "host-only drain's rows")
    out["host_only_s"] = time.perf_counter() - t0
    out["host_only_rows_per_s"] = ST_ROWS / out["host_only_s"]
    # the stage split from a second drain: the timer and the kept tokens
    # stay out of host_only_s
    with HashStages() as stages:
        t0 = time.perf_counter()
        require(drain_host_only() == ST_ROWS, "host-only drain's rows")
        staged_s = time.perf_counter() - t0
    out.update(host=host_cpu(), host_only_stages_s=stages.split(staged_s),
               hash_in_turns=stages.hash_in_turns())
    drain_full_dag()                                  # warm
    t0 = time.perf_counter()
    out["dag_last_window_auc"] = drain_full_dag()
    out["dag_s"] = time.perf_counter() - t0
    out["dag_rows_per_s"] = ST_ROWS / out["dag_s"]
    # bench.py: label-shuffled data would pin the AUC at 0.5
    require(out["dag_last_window_auc"] > 0.52,
            f"the DAG learns: last window AUC {out['dag_last_window_auc']}")
    first = FeatureHasherBatchOp(**ST_HASH).link_from(MemSourceBatchOp(
        table.first_n(ST_MICRO))).get_output_table()
    out["stage_ms"] = dict(trainer_stages(ftrl.trainer, first, 3,
                                          allow_fb=True)[0], rows=ST_MICRO)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain_stream()
        wall = time.perf_counter() - t0
    busy = sum(float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)))
               for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e6
    out.update(profiled_stream_s=wall, device_busy_s=busy,
               device_busy_share=busy / wall)
    return out


def demotion_check(tf):
    """A stream whose first micro-batch is field-blocked (3 fields of 16,
    one-hot) and whose second is not (a second slot in field 0), float32
    on the card: the op's final snapshot bitwise equal to the trainer's
    stages run by hand (the fb step, the exact fb -> std translation, the
    padded-COO step), and the fb state's coefficients equal to the
    translated state's."""
    import torch
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    rng = np.random.default_rng(14)
    vecs = np.empty(512, object)
    for i in range(512):
        ix = np.arange(3) * 16 + rng.integers(0, 16, 3)
        if i >= 256:
            ix = np.unique(np.append(ix, (ix[0] + 1) % 16))
        vecs[i] = SparseVector(48, ix, np.ones(len(ix)))
    table = MTable({"vec": vecs, "label": rng.integers(0, 2, 512)},
                   "vec VECTOR, label LONG")
    warm = MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(rng.standard_normal(49) * 0.1,
                                has_intercept=True, label_values=[1, 0],
                                vector_col="vec", vector_size=48,
                                label_type="LONG")))
    op = tf.FtrlTrainStreamOp(warm, vector_col="vec", label_col="label",
                              update_mode="batch", time_interval=1e9,
                              **FTRL_HP).link_from(
        MemSourceStreamOp(table, batch_size=256))
    (_, snap), = list(op.timed_batches())
    tr = op.trainer
    enc = tr.encode(table.first_n(256), 256, allow_fb=True)
    require(enc.kind == "fb", "the first micro-batch is field-blocked")
    z, n = tr.initial_state(enc)
    z, n, _ = tr.step(tr.to_device(enc), z, n)
    fb_coef = _coefs(tr.snapshot(z, n, 16))
    z, n = tr.to_std_state(z, n, 16)
    require(np.array_equal(_coefs(tr.snapshot(z, n)).view(np.int64),
                           fb_coef.view(np.int64)),
            "the fb -> std translation keeps every coefficient's bits")
    second = table.take_rows(np.arange(256, 512))
    enc2 = tr.encode(second, 256)
    require(enc2.kind == "sparse", "the second micro-batch is not "
                                   "field-blocked")
    z, n, _ = tr.step(tr.to_device(enc2), z, n)
    require(np.array_equal(_coefs(tr.snapshot(z, n)).view(np.int64),
                           _coefs(snap).view(np.int64)),
            "the demoted stream's snapshot equals the translation by hand")
    return {"fb_micro_batches": 1, "demoted_micro_batches": 1,
            "bitwise": True}


def hooks_check(tf, table):
    """The two hooks on the card over 4 micro-batches of the bench stream
    (hashed field-aware, a snapshot every 2 s): the batch hook's pre and
    post calls in order, and a consumer that takes every hand-off, handed
    the live weights on the card, leaves no host snapshot."""
    import torch
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    warm = MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(np.zeros(3 * BF_S + 1), has_intercept=True,
                                label_values=[1, 0], vector_col="vec",
                                vector_size=3 * BF_S, label_type="LONG")))
    calls, handed = [], []

    def consumer(w, info):
        handed.append((w.device.type, tuple(w.shape), dict(info)))
        return True
    op = tf.FtrlTrainStreamOp(warm, vector_col="vec", label_col="click",
                              update_mode="batch", time_interval=2.0,
                              **FTRL_HP)
    op.set_batch_hook(lambda *a: calls.append(a))
    op.set_device_snapshot_consumer(consumer)
    op.link_from(FeatureHasherStreamOp(**ST_HASH).link_from(
        MemSourceStreamOp(table.first_n(4 * ST_MICRO), batch_size=ST_MICRO)))
    snaps = list(op.timed_batches())
    want = [(ph, b, float(b - 1)) for b in range(1, 5)
            for ph in ("pre", "post")]
    require([(ph, b, float(t)) for ph, b, t in calls] == want,
            f"batch hook calls {calls} are pre/post of each micro-batch in "
            f"order")
    require(snaps == [] and len(handed) == 2
            and all(d == "cuda" and s == (4 * BF_S,) for d, s, _ in handed)
            and handed[0][2]["fb_S"] == BF_S,
            f"the consumer took every boundary's live card weights and no "
            f"host snapshot was made ({len(snaps)} snapshots, {handed})")
    torch.cuda.synchronize()
    return {"hook_calls": len(calls), "consumer_calls": len(handed),
            "host_snapshots": len(snaps)}


def phase_batch(kernels, rng, lat, card):
    """14: FTRL's batch mode on the card at bench_ftrl's shapes."""
    from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
    kl, kf = kernels
    tag = f"[{card}]"
    out = {"card": card}
    t0 = time.perf_counter()
    parity = {}
    for case, kinds in SCATTER_CASES:
        for kind in kinds:
            key = f"{case} {kind}"
            parity[key] = scatter_case(kl, rng, case, kind, lat)
            print(f"scatter_walk {tag} {key}: " + " ".join(
                f"{k}={v}" for k, v in parity[key].items()), flush=True)
    out["scatter_s"] = time.perf_counter() - t0
    out["gather_pair"] = batch_gathers(kf, rng)
    for key, rec in out["gather_pair"].items():
        print(f"ftrl_gather_pair {tag} {key}: {rec}", flush=True)
    steps = {}
    for kind in STEP_KINDS:
        steps[kind] = step_case(tf, kl, kf, rng, kind)
        print(f"batch step {tag} {kind}: {steps[kind]}", flush=True)
    out["steps"] = steps
    out["main_path"] = batch_main_path(kl, kf, rng)
    print(f"batch main path {tag}: {out['main_path']}", flush=True)
    table = bench_stream_data()
    out["stream"] = bench_stream(kl, kf, table)
    print(f"bench stream {tag}: {out['stream']}", flush=True)
    out["demotion"] = demotion_check(tf)
    out["hooks"] = hooks_check(tf, table)
    print(f"demotion and hooks {tag}: {out['demotion']} {out['hooks']}",
          flush=True)
    return parity, out



# ---------------------------------------------------------------------------
# the host's hashing stages (phases 13 and 14) and 15. the ingest path
# ---------------------------------------------------------------------------

def host_cpu() -> str:
    """The host's CPU and core count: the ingest path and the hashing run
    on it, and hosts of one card type differ by up to 2x. The model name
    with the vendor, family, model number and clock that ``/proc/cpuinfo``
    gives (some hosts report the model as "unknown"), the
    architecture and ``os.cpu_count()``."""
    import os
    import platform
    keys = ("model name", "vendor_id", "cpu family", "model", "cpu MHz")
    got = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                k = k.strip()
                if k in keys and k not in got:
                    got[k] = v.strip()
                if not line.strip() and got:
                    break
    except OSError:
        pass
    ids = ", ".join(f"{k} {got[k]}" for k in keys[1:] if k in got)
    return (f"{got.get('model name', 'CPU model not reported')} ({ids}; "
            f"{platform.machine()}), {os.cpu_count()} cores")


class HashStages:
    """Times the feature hasher's stages inside a drain: token formatting
    (``_format_tokens``), hashing (``murmur32_cells``) and building the
    rows (``_flat_rows``, or ``SparseVectorColumn`` field-aware), each by
    host clock summed over its calls; keeps every hashing call's
    arguments, so :meth:`hash_in_turns` can time the native hash against
    its numpy plain version on the same tokens."""

    STAGES = (("format", "_format_tokens"), ("hash", "murmur32_cells"),
              ("rows", "_flat_rows"), ("rows", "SparseVectorColumn"))

    def __init__(self):
        self.s = {"format": 0.0, "hash": 0.0, "rows": 0.0}
        self.calls = []
        self._lock = threading.Lock()
        self._saved = {}

    def _timed(self, stage, fn, keep):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.s[stage] += dt
                    if keep:
                        self.calls.append((a, k))
        return timed

    def __enter__(self):
        from alink_tpu_torch.operator.batch.feature import feature_ops as fo
        self._fo = fo
        for stage, name in self.STAGES:
            self._saved[name] = getattr(fo, name)
            setattr(fo, name, self._timed(stage, self._saved[name],
                                          stage == "hash"))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._fo, name, fn)
        return False

    def split(self, total_s: float) -> dict:
        return dict(self.s, other=total_s - sum(self.s.values()),
                    total=total_s,
                    tokens=sum(len(a[0]) for a, _ in self.calls))

    def hash_in_turns(self, rounds: int = 2) -> dict:
        """The native hash and the numpy plain version (the hash before
        the native path) over this drain's tokens, in turns (plain,
        native, native, plain), each turn all the calls; bitwise equal."""
        fo = self._fo
        for a, k in self.calls:
            require(np.array_equal(fo.murmur32_cells(*a, **k),
                                   fo.murmur32_cells_plain(*a, **k)),
                    "the native hash equals its plain version")
        times = {"native": [], "plain": []}
        for _ in range(rounds):
            for name in ("plain", "native", "native", "plain"):
                fn = fo.murmur32_cells if name == "native" \
                    else fo.murmur32_cells_plain
                t0 = time.perf_counter()
                for a, k in self.calls:
                    fn(*a, **k)
                times[name].append(time.perf_counter() - t0)
        native = float(np.median(times["native"]))
        plain = float(np.median(times["plain"]))
        return {"native_s": native, "plain_s": plain,
                "plain_over_native": plain / native,
                "turns": times, "calls": len(self.calls)}


# bench.py::bench_logreg_from_disk (bench.py:1266-1460): make_ctr_fieldblock
# rows (bench.py:488, 32 fields of 2048, seed 42) at its default of
# 1,000,000 rows, read in 64 shards, sent to the card in 16 groups, three
# L-BFGS supersteps
DISK_ROWS, DISK_SEED, DISK_SHARDS, DISK_GROUPS = 1_000_000, 42, 64, 16
DISK_STEPS, DISK_REPS = 3, 3
# (b): make_batch_criteo rows (bench.py:313: 39 distinct one-hot slots
# over 65,536), read by LibSvmSourceBatchOp; held-out rows served
INGEST_ROWS, INGEST_HELD, INGEST_DIM, INGEST_SHARDS = 100_000, 8192, 65_536, 4


def write_fieldblock_libsvm(path, fb, y):
    """The rows as LibSVM lines ``label j:1 ...`` (1-based global ids,
    field by field), bench.py's bytes, written to a temporary name and
    renamed."""
    import os
    n, f = fb.shape
    flat = fb + (np.arange(f, dtype=np.int32) * LR_FIELD_SIZE)[None, :]
    tok = np.array([f" {j + 1}:1".encode() for j in range(f * LR_FIELD_SIZE)],
                   object)
    lab = np.where(y > 0, b"1", b"-1").astype(object)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as out:
        for lo in range(0, n, 100_000):
            hi = min(lo + 100_000, n)
            cells = np.empty((hi - lo, f + 2), object)
            cells[:, 0] = lab[lo:hi]
            cells[:, 1:f + 1] = tok[flat[lo:hi]]
            cells[:, f + 1] = b"\n"
            out.write(b"".join(cells.ravel().tolist()))
    os.replace(tmp, path)


def disk_train(fb, y, dev):
    """bench_logreg_from_disk's train leg: three field-blocked L-BFGS
    supersteps (l2 1e-4, epsilon 0, no warm start) through the port's
    ``optimize``; the coefficients on the host."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
    meta = FieldBlockMeta(LR_FIELDS, LR_FIELD_SIZE)
    obj = ob.UnaryLossObjFunc(ob.LogLossFunc(), meta.dim, l2=LR_L2,
                              fb_meta=meta)
    w = torch.ones_like(y) if isinstance(y, torch.Tensor) \
        else np.ones(len(y), np.float32)
    coef, _, steps = opt.optimize(obj, {"fb_idx": fb, "y": y, "w": w},
                                  opt.OptimParams(method="LBFGS",
                                                  max_iter=DISK_STEPS,
                                                  epsilon=0.0),
                                  MLEnvironment(device=dev))
    require(steps == DISK_STEPS, f"{DISK_STEPS} supersteps ran: {steps}")
    return np.asarray(coef)


def disk_pipeline(ks, kl, dev):
    """15(a): the LibSVM fixture through the port's loader
    (``io/fieldblock.py::load_fieldblock_libsvm``: 64 byte-range shards
    on ``prefetch_map``'s pool, parsed by ``parse_libsvm_fb16`` into
    int16 field-local ids and float32 labels, 16 pinned groups copied
    with ``non_blocking=True``, one ``torch.cat`` and the int16 -> int32
    widening on the card) and the train leg, in bench.py's paired reps,
    against the same training from the generated arrays in memory."""
    import os
    import tempfile
    import torch
    from alink_tpu_torch.io.fieldblock import load_fieldblock_libsvm
    from alink_tpu_torch.io.sharding import read_file_shard
    from alink_tpu_torch.operator.stream.prefetch import prefetch_map

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def disk_load():
        return load_fieldblock_libsvm(path, LR_FIELDS, LR_FIELD_SIZE,
                                      shards=DISK_SHARDS,
                                      groups=DISK_GROUPS, device=dev)

    fb_true, y_true = ctr_fieldblock(DISK_ROWS, DISK_SEED)
    path = os.path.join(tempfile.gettempdir(),
                        f"alink_torch_diskbench_{DISK_ROWS}_{LR_FIELDS}_"
                        f"{os.getpid()}.libsvm")
    out = {"rows": DISK_ROWS, "shards": DISK_SHARDS}
    try:
        t0 = time.perf_counter()
        write_fieldblock_libsvm(path, fb_true, y_true)
        out["fixture_write_s"] = time.perf_counter() - t0
        out["fixture_mb"] = os.path.getsize(path) / 1e6
        # the main path, counted: load and train once
        ks.reset_launch_counts()
        kl.reset_launch_counts()
        fb, labels, st = disk_load()
        out["workers"] = workers = st["workers"]
        coef_disk = disk_train(fb, labels, dev)
        sync()
        out["launches"] = {**ks.launch_counts(), **kl.launch_counts()}
        for name in ("linear_grad", "serve_sparse"):
            require(out["launches"][name] > 0 or dev.type != "cuda",
                    f"the from-disk path launched {name}: "
                    f"{out['launches']}")
        require(fb.dtype == torch.int32 and fb.device.type == dev.type
                and np.array_equal(fb.cpu().numpy(), fb_true),
                "the card's field ids equal the generated ones")
        require(labels.cpu().numpy().tobytes() == y_true.tobytes(),
                "the card's labels equal the generated ones bitwise")
        coef_mem = disk_train(fb_true, y_true, dev)
        require(coef_disk.tobytes() == coef_mem.tobytes(),
                "the coefficients trained from disk equal those trained "
                "from memory bitwise")
        del fb, labels
        pipe, mem, ratio, splits = [], [], [], []
        for _ in range(DISK_REPS):
            sync()
            t0 = time.perf_counter()
            fb, labels, split = disk_load()
            disk_train(fb, labels, dev)
            sync()
            t_pipe = time.perf_counter() - t0
            del fb, labels
            t0 = time.perf_counter()
            disk_train(fb_true, y_true, dev)
            sync()
            t_mem = time.perf_counter() - t0
            pipe.append(t_pipe)
            mem.append(t_mem)
            ratio.append(t_mem / t_pipe)
            splits.append(split)
        k = int(np.argsort(pipe)[len(pipe) // 2])
        split = splits[k]
        out.update(split, train_s=pipe[k] - split["rp_wall_s"],
                   pipeline_s=pipe[k],
                   memory_s=float(np.median(mem)),
                   pipeline_samples_per_s=DISK_ROWS / pipe[k],
                   memory_samples_per_s=DISK_ROWS / float(np.median(mem)),
                   source_samples_per_s=DISK_ROWS / split["rp_wall_s"],
                   pipeline_vs_memory=float(np.median(ratio)),
                   reps={"pipeline_s": pipe, "memory_s": mem,
                         "ratio": ratio})
        # the rig's raw read rate: the loader's sharded reads on its pool
        # at its width, no parse
        t0 = time.perf_counter()
        sizes = list(prefetch_map(
            iter(range(DISK_SHARDS)),
            lambda i: len(read_file_shard(path, i, DISK_SHARDS)),
            workers=workers))
        read_s = time.perf_counter() - t0
        require(sum(sizes) == os.path.getsize(path),
                "the shards read the whole fixture")
        out.update(rig_read_s=read_s,
                   rig_read_mb_per_s=out["fixture_mb"] / read_s,
                   source_mb_per_s=out["fixture_mb"] / split["rp_wall_s"])
    finally:
        if os.path.exists(path):
            os.remove(path)
    return out


def criteo_batch(seed, n):
    """bench.py::make_batch_criteo (bench.py:313) at ``B = n``: 39
    distinct one-hot slots of 65,536 a row (slot 0 left to the
    intercept), labels from the logistic of a seeded sparse true model;
    as a table (label DOUBLE, features SPARSE_VECTOR)."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    r = np.random.RandomState(seed)
    rngw = np.random.RandomState(0)
    w_true = (rngw.randn(INGEST_DIM) * (rngw.rand(INGEST_DIM) < 0.02))
    raw = r.randint(1, INGEST_DIM, size=(n, NNZ)).astype(np.int32)
    for _ in range(64):                   # resample intra-row collisions
        srt = np.sort(raw, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        if not dup.any():
            break
        raw[dup] = r.randint(1, INGEST_DIM, size=(int(dup.sum()), NNZ))
    y = (r.rand(n) < 1.0 / (1.0 + np.exp(-w_true[raw].sum(1)))).astype(
        np.float64)
    vecs = np.empty(n, object)
    ones = np.ones(NNZ)
    vecs[:] = [SparseVector(INGEST_DIM, raw[i], ones) for i in range(n)]
    return MTable({"label": y, "features": vecs},
                  "label DOUBLE, features SPARSE_VECTOR")


def served_labels_match(gpu, req, table, name):
    """``CompiledPredictor`` (holding ``table``) labels ``req`` as its
    float64 host mapper's ``map_table`` does, outside the float32
    rounding band of each row's score; returns the host scores and the
    rows inside the band."""
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    col = req.col_names[0]
    card = [str(v) for v in gpu.predict_table(req).col("pred")]
    host_map = gpu._active.mapper
    s_host = host_map.predict_scores(req)
    host = [str(v) for v in host_map.map_table(req).col("pred")]
    c = LinearModelDataConverter.load_table(table).coef
    terms = np.asarray([abs(c[0]) + np.abs(c[1 + v.indices]).sum()
                        for v in req.col(col)])
    clear = np.abs(s_host) > 64 * 2.0 ** -24 * terms
    require(all(a == b for a, b, ok in zip(card, host, clear) if ok),
            f"CompiledPredictor labels ({name}) equal map_table's outside "
            f"the rounding band")
    return s_host, int((~clear).sum())


def libsvm_source_path(ks, kl, dev):
    """15(b): Criteo-shape rows written by ``LibSvmSinkBatchOp``, read by
    ``LibSvmSourceBatchOp`` (whole, and as the union of 4 shards) ->
    ``LogisticRegressionTrainBatchOp`` -> ``CompiledPredictor``; the
    model from the file bitwise equal to the model from the same rows in
    a ``MemSourceBatchOp``."""
    import os
    import tempfile
    import torch
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.types import TableSchema
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.sink import LibSvmSinkBatchOp
    from alink_tpu_torch.operator.batch.source import (LibSvmSourceBatchOp,
                                                       MemSourceBatchOp)
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.serving import CompiledPredictor

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    table = criteo_batch(7, INGEST_ROWS)
    held = criteo_batch(8, INGEST_HELD)
    path = os.path.join(tempfile.gettempdir(),
                        f"alink_torch_criteo_{os.getpid()}.libsvm")
    out = {"rows": INGEST_ROWS, "features": INGEST_DIM}
    try:
        t0 = time.perf_counter()
        LibSvmSinkBatchOp(file_path=path, label_col="label",
                          vector_col="features").link_from(
            MemSourceBatchOp(table))
        out["write_s"] = time.perf_counter() - t0
        out["file_mb"] = os.path.getsize(path) / 1e6

        def source(**kw):
            return LibSvmSourceBatchOp(file_path=path,
                                       vector_size=INGEST_DIM, **kw)

        def parts(t):
            v = t.col("features")
            return (np.asarray(t.col("label")).tobytes(),
                    np.concatenate([x.indices for x in v]).tobytes(),
                    np.concatenate([x.values for x in v]).tobytes(),
                    [len(x.indices) for x in v], {x.n for x in v})

        t0 = time.perf_counter()
        whole = source().get_output_table()
        out["read_s"] = time.perf_counter() - t0
        require(parts(whole) == parts(table),
                "the file reads back the written rows bitwise")
        shards = [source(sharded=True, shard_index=i,
                         num_shards=INGEST_SHARDS).get_output_table()
                  for i in range(INGEST_SHARDS)]
        union = shards[0]
        for s in shards[1:]:
            union = union.concat_rows(s)
        require(parts(union) == parts(whole)
                and sum(s.num_rows for s in shards) == whole.num_rows,
                f"the union of {INGEST_SHARDS} sharded reads is the whole "
                f"table")
        out["shard_rows"] = [s.num_rows for s in shards]
        # the main path, counted: file -> LR -> CompiledPredictor
        ks.reset_launch_counts()
        kl.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        lr = LogisticRegressionTrainBatchOp(
            vector_col="features", label_col="label", l2=LR_L2,
            device=dev).link_from(source())
        model = lr.get_output_table()
        sync()
        out["train_s"] = time.perf_counter() - t0
        curve = np.asarray(lr.get_side_output(0).get_output_table()
                           .col("loss"))
        require(np.isfinite(curve).all() and curve[-1] < curve[0],
                "the loss fell")
        mapper = LinearModelMapper(
            model.schema, TableSchema(["features"], ["SPARSE_VECTOR"]),
            Params({"prediction_col": "pred", "vector_col": "features"}))
        mapper.load_model(model)
        gpu = CompiledPredictor(mapper, device=dev)
        req = held.select(["features"])
        s_host, band = served_labels_match(gpu, req, model, "from the file")
        sync()
        out["launches"] = {**ks.launch_counts(), **kl.launch_counts()}
        for k in ("linear_grad", "serve_sparse"):
            require(out["launches"][k] > 0 or dev.type != "cuda",
                    f"the file path launched {k}: {out['launches']}")
        mem = LogisticRegressionTrainBatchOp(
            vector_col="features", label_col="label", l2=LR_L2,
            device=dev).link_from(MemSourceBatchOp(table))
        require(model.to_rows() == mem.get_output_table().to_rows(),
                "the model trained from the file equals the model trained "
                "from memory")
        out.update(supersteps=len(curve), loss_first=float(curve[0]),
                   loss_last=float(curve[-1]), rows_in_rounding_band=band,
                   held_out_auc=rank_auc(
                       np.asarray(held.col("label")).astype(np.int64),
                       s_host))
    finally:
        if os.path.exists(path):
            os.remove(path)
    return out


def phase_ingest(kernels, card, dev=None):
    """15: the ingest path: (a) bench_logreg_from_disk on the port, (b) a
    LibSVM file through the batch source, L-BFGS and serving. ``kernels``
    are the ``serve`` and ``linear`` kernel modules."""
    import torch
    ks, kl = kernels
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    host = host_cpu()
    tag = f"[{card}] [{host}]"
    out = {"card": card, "host": host,
           "disk": disk_pipeline(ks, kl, dev)}
    d = out["disk"]
    print(f"ingest (a) {tag}: {DISK_ROWS} rows, {d['fixture_mb']:.1f} MB "
          f"in {DISK_SHARDS} shards on {d['workers']} workers: read_s "
          f"{d['read_s']} parse_s {d['parse_s']} copy_s {d['copy_s']} "
          f"rp_wall_s {d['rp_wall_s']} train_s {d['train_s']}; pipeline "
          f"{d['pipeline_samples_per_s']} samples/s, in memory "
          f"{d['memory_samples_per_s']} samples/s, pipeline_vs_memory "
          f"{d['pipeline_vs_memory']}; raw read {d['rig_read_mb_per_s']} "
          f"MB/s, source {d['source_mb_per_s']} MB/s; launches "
          f"{d['launches']}", flush=True)
    out["libsvm"] = b = libsvm_source_path(ks, kl, dev)
    print(f"ingest (b) {tag}: {INGEST_ROWS} rows ({b['file_mb']:.1f} MB) "
          f"written {b['write_s']:.3f} s, read {b['read_s']:.3f} s, "
          f"{INGEST_SHARDS} shards {b['shard_rows']}, LR "
          f"{b['supersteps']} supersteps in {b['train_s']:.3f} s, held-out "
          f"AUC {b['held_out_auc']}, launches {b['launches']}", flush=True)
    out["launches"] = {k: d["launches"].get(k, 0) + b["launches"].get(k, 0)
                       for k in set(d["launches"]) | set(b["launches"])}
    return out


# ---------------------------------------------------------------------------
# 16. the rest of the linear family and KMeans: bench_softmax's and
# bench_kmeans's shapes, sparse Softmax and the family on Criteo rows
# ---------------------------------------------------------------------------

SM_ROWS, SM_DIM, SM_K, SM_L2 = 60_000, 784, 10, 1e-4
SM_TIMED_STEPS, SM_CHECK_STEPS, SM_CONVERGE_MAX = 30, 10, 60
SM_PROFILED = (5, 9)                     # supersteps under the profiler
SM_F64_ROWS, SM_SERVE_ROWS = 6_000, 4096
SPS_ROWS, SPS_HELD, SPS_K, SPS_STEPS = 100_000, 8192, 4, 30
FAMILY_STEPS, NEWTON_STEPS, SGD_FRACTION = 20, 8, 0.1
F64_STEPS = 10                           # float64 card vs CPU, sparse ops
KM_REPS, KM_K, KM_NOISE = 10_000, 3, 0.05
KM_TIMED_STEPS, KM_CHECK_STEPS, KM_CONVERGE_MAX = 200, 20, 500
KM_PROFILED = (50, 59)
# Fisher's iris: each class's mean and standard deviation of sepal
# length, sepal width, petal length, petal width (cm); 50 rows a class
IRIS_MEANS = ((5.006, 3.428, 1.462, 0.246), (5.936, 2.770, 4.260, 1.326),
              (6.588, 2.974, 5.552, 2.026))
IRIS_STDS = ((0.352, 0.379, 0.174, 0.105), (0.516, 0.314, 0.470, 0.198),
             (0.636, 0.322, 0.552, 0.275))
U32 = 2.0 ** -24


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def np_bits_equal(a, b) -> bool:
    """Two host float arrays with the same bits."""
    a, b = np.asarray(a), np.asarray(b)
    view = np.int64 if a.dtype == np.float64 else np.int32
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        np.array_equal(a.view(view), b.view(view)))


def softmax_data(seed=0):
    """bench.py::bench_softmax's data (:637-641): k centers ``randn * 0.5``,
    a center per row plus ``randn`` noise, float32, the intercept column
    first; class ids ``yc``."""
    n, d, k = SM_ROWS, SM_DIM, SM_K
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32) * 0.5
    yc = rng.randint(0, k, n)
    X = (centers[yc] + rng.randn(n, d).astype(np.float32)).astype(np.float32)
    return np.concatenate([np.ones((n, 1), np.float32), X], 1), yc


def softmax_run(data, steps, dev, eps=0.0):
    """bench_softmax's training through ``optimize``: ``SoftmaxObjFunc``
    (l2 1e-4, the intercept column unregularized), warm start ``randn *
    1e-6`` (seed 11), L-BFGS. Returns (coef, curve, supersteps, s)."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    d, k = data["X"].shape[1], SM_K
    obj = ob.SoftmaxObjFunc(k, d, l2=SM_L2, reg_free_cols=1)
    w0 = (np.random.RandomState(11).randn((k - 1) * d) * 1e-6).astype(
        np.float64 if data["X"].dtype == torch.float64 else np.float32)
    _sync(dev)
    t0 = time.perf_counter()
    coef, curve, n = opt.optimize(obj, data, opt.OptimParams(
        method="LBFGS", max_iter=steps, epsilon=eps), MLEnvironment(
        device=dev), warm_start=w0)
    return coef, curve, n, time.perf_counter() - t0


def softmax_tensors(X, yc, dev, dtype):
    import torch
    X = torch.from_numpy(np.ascontiguousarray(X)).to(dev, dtype)
    return {"X": X, "y": torch.from_numpy(yc.astype(np.float64)).to(dev,
                                                                     dtype),
            "w": torch.ones(X.shape[0], dtype=dtype, device=dev)}


def softmax_model_table(coef, d, k, vector_col="vec"):
    """A Softmax model table of ``coef`` ((k-1) x (d+1), intercept
    first), classes 0..k-1."""
    from alink_tpu_torch.operator.common.linear.base import (
        LinearModelData, LinearModelDataConverter)
    return LinearModelDataConverter("LONG").save_model(LinearModelData(
        model_name="Softmax model", linear_model_type="Softmax",
        has_intercept=True, vector_col=vector_col, feature_names=None,
        vector_size=d, coef=np.asarray(coef, np.float64),
        label_values=list(range(k)), label_type="LONG"))


def softmax_labels_match(gpu, req, table, name, X=None):
    """``CompiledPredictor`` labels equal to its float64 host mapper's
    ``map_table`` outside the float32 rounding band of the two leading
    logits (``X`` the dense request rows, else the sparse rows' one-hot
    slots); returns the rows inside the band."""
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    m = LinearModelDataConverter.load_table(table)
    k = len(m.label_values)
    W = m.coef.reshape(k - 1, -1)
    card = [str(v) for v in gpu.predict_table(req).col("pred")]
    host_map = gpu._active.mapper
    z = host_map.predict_scores(req)                      # (n, k), pivot 0
    host = [str(v) for v in host_map.map_table(req).col("pred")]
    if X is not None:
        terms = np.abs(X) @ np.abs(W[:, 1:]).T + np.abs(W[:, 0])
    else:
        terms = np.stack([np.abs(W[:, 1:][:, v.indices]).sum(1)
                          for v in req.col(req.col_names[0])]) \
            + np.abs(W[:, 0])
    terms = np.concatenate([terms, np.zeros((len(terms), 1))], 1)
    top2 = np.argsort(-z, 1)[:, :2]
    rows = np.arange(len(z))
    gap = z[rows, top2[:, 0]] - z[rows, top2[:, 1]]
    band = 64 * U32 * (terms[rows, top2[:, 0]] + terms[rows, top2[:, 1]])
    clear = gap > band
    require(all(a == b for a, b, ok in zip(card, host, clear) if ok),
            f"CompiledPredictor labels ({name}) equal map_table's outside "
            f"the rounding band")
    return int((~clear).sum())


def served_scores_match(gpu, req, table, name):
    """``CompiledPredictor`` scores of a regression model within the
    float32 rounding band of the float64 host mapper's; returns the
    largest gap over its band."""
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    col = req.col_names[0]
    card = np.asarray(gpu.predict_table(req).col("pred"), np.float64)
    host = np.asarray(gpu._active.mapper.map_table(req).col("pred"),
                      np.float64)
    c = LinearModelDataConverter.load_table(table).coef
    terms = np.asarray([abs(c[0]) + np.abs(c[1 + v.indices]).sum()
                        for v in req.col(col)])
    ratio = np.abs(card - host) / (64 * U32 * terms)
    require(bool((ratio <= 1.0).all()),
            f"CompiledPredictor scores ({name}) within the rounding band of "
            f"map_table's (worst {ratio.max()} of the band)")
    return float(ratio.max())


def phase_softmax_dense(ks, dev, card):
    """16(a): bench_softmax at its full shape on the card: 30 timed
    supersteps (ms, samples/s, stages, busy share), supersteps to
    converge and the training accuracy, two runs bitwise, float64 card vs
    CPU on the first 6,000 rows, and the model served by
    ``CompiledPredictor`` (dense requests: B4 once for each class
    column)."""
    import torch
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.types import TableSchema
    from alink_tpu_torch.common.vector import DenseVector
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.serving import CompiledPredictor
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is off for the dense products")
    X, yc = softmax_data()
    n, d = X.shape
    t0 = time.perf_counter()
    data = softmax_tensors(X, yc, dev, torch.float32)
    _sync(dev)
    out = {"rows": n, "cols": d, "k": SM_K, "l2": SM_L2,
           "to_card_s": time.perf_counter() - t0}
    softmax_run(data, 3, dev)                             # warm-up
    with SuperstepClock(profile=SM_PROFILED
                        if torch.device(dev).type == "cuda" else None) \
            as clock:
        _, curve, steps, secs = softmax_run(data, SM_TIMED_STEPS, dev)
    require(steps == SM_TIMED_STEPS and np.isfinite(curve).all(),
            "Softmax ran its fixed-length supersteps with finite losses")
    per = clock.superstep_ms()
    traced = np.arange(SM_PROFILED[0] - 2, SM_PROFILED[1] - 1)
    ms = float(np.median(np.delete(per, traced)))
    out.update(ms_per_superstep=ms, superstep_ms_min=float(per.min()),
               superstep_ms_max=float(per.max()), run_s=secs,
               samples_per_s=n / ms * 1e3, loss_first=float(curve[0]),
               loss_last=float(curve[-1]))
    if clock.prof is not None:
        kk = SM_PROFILED[1] - SM_PROFILED[0] + 1
        _, total, busy = clock.profiled()
        out.update(device_ops_per_superstep=total / kk,
                   device_busy_ms=busy / kk,
                   device_busy_share=busy / kk / ms)
    pieces = [(ob.SoftmaxObjFunc, "calc_grad_eta_shard"),
              (ob.SoftmaxObjFunc, "_grad_loss_from_logits"),
              (ob.SoftmaxObjFunc, "line_losses_shard")]
    with StageSplit(pieces) as split:
        softmax_run(data, SM_CHECK_STEPS, dev)
    med = split.raw_medians()
    out["stage_ms"] = {
        "logits": med["calc_grad_eta_shard"] - med["_grad_loss_from_logits"],
        "gradient": med["_grad_loss_from_logits"],
        "gradient_stage": med["calc_grad"],
        "direction": med["direction_and_losses"] - med["line_losses_shard"],
        "line_search": med["line_losses_shard"],
        "update": med["update_model"],
        "superstep_sum": med["calc_grad"] + med["direction_and_losses"]
        + med["update_model"]}
    coef, conv_curve, n_conv, conv_s = softmax_run(
        data, SM_CONVERGE_MAX, dev, eps=1e-6)
    W = torch.tensor(np.asarray(coef), device=dev).reshape(SM_K - 1, d)
    z = torch.cat([data["X"] @ W.T, torch.zeros(n, 1, device=dev)], 1)
    acc = float((z.argmax(1).cpu().numpy() == yc).mean())
    out.update(supersteps_to_converge=n_conv, converge_s=conv_s,
               converged_loss=float(conv_curve[-1]), train_accuracy=acc)
    require(acc > 0.9, f"Softmax trains: accuracy {acc}")
    a = softmax_run(data, SM_CHECK_STEPS, dev)
    b = softmax_run(data, SM_CHECK_STEPS, dev)
    require(np_bits_equal(a[0], b[0]) and np_bits_equal(a[1], b[1]),
            "two float32 card runs give bitwise-equal coefficients and "
            "loss curves")
    m = SM_F64_ROWS
    gc, gl, _, _ = softmax_run(softmax_tensors(X[:m], yc[:m], dev,
                                               torch.float64),
                               SM_CHECK_STEPS, dev)
    cc, cl, _, cpu_s = softmax_run(softmax_tensors(X[:m], yc[:m], "cpu",
                                                   torch.float64),
                                   SM_CHECK_STEPS, "cpu")
    gap = np.abs(gl - cl) / np.abs(cl)
    require(bool((gap <= 1e-10).all()),
            f"the float64 card run's loss curve within rtol 1e-10 of the "
            f"CPU's over {SM_CHECK_STEPS} supersteps (max rel {gap.max()})")
    out.update(two_runs_bitwise=True, card_vs_cpu_f64={
        "rows": m, "supersteps": SM_CHECK_STEPS,
        "loss_max_rel_gap": float(gap.max()),
        "coef_max_abs_gap": float(np.abs(gc - cc).max()),
        "coef_max_abs": float(np.abs(cc).max()), "cpu_s": cpu_s})
    # the converged model served: dense requests, B4 once for each of the
    # k - 1 non-pivot class columns
    table = softmax_model_table(coef, d - 1, SM_K)
    Xr = X[:SM_SERVE_ROWS, 1:].astype(np.float64)
    vecs = np.empty(len(Xr), object)
    vecs[:] = [DenseVector(x) for x in Xr]
    req = MTable({"vec": vecs}, "vec VECTOR")
    mapper = LinearModelMapper(table.schema, TableSchema(["vec"], ["VECTOR"]),
                               Params({"prediction_col": "pred",
                                       "vector_col": "vec"}))
    mapper.load_model(table)
    gpu = CompiledPredictor(mapper, device=dev)
    ks.reset_launch_counts()
    band = softmax_labels_match(gpu, req, table, "dense Softmax", X=Xr)
    launches = ks.launch_counts()
    chunks = -(-len(Xr) // gpu.buckets[-1])
    if torch.device(dev).type == "cuda":
        require(launches["serve_dense"] == chunks * (SM_K - 1),
                f"dense Softmax serving launches B4 once a class column a "
                f"chunk: {launches}")
    out["served"] = {"rows": len(Xr), "rows_in_rounding_band": band,
                     "launches": launches}
    print(f"softmax (a) [{card}]: {n} x {d}, k {SM_K}: {ms:.4f} ms a "
          f"superstep (median of {len(per) - len(traced)}), "
          f"{out['samples_per_s']:.1f} samples/s, busy "
          f"{out.get('device_busy_share')}, stages {out['stage_ms']}; "
          f"{n_conv} supersteps to converge, accuracy {acc}; two runs "
          f"bitwise; f64 card vs CPU loss gap {gap.max()}; served "
          f"{len(Xr)} rows ({band} in the band), launches {launches}",
          flush=True)
    return out


def criteo_softmax_rows(seed, n):
    """bench.py::make_batch_criteo's rows (39 distinct one-hot slots of
    65,536 a row, slot 0 left to the intercept) with three labels from
    seeded sparse linear models over the slots: ``label``, the argmax
    over k classes of the logits plus Gumbel noise; ``bin``, whether it
    is class 0 or 1; ``target``, class 0's logit less class 1's plus
    0.3 ``randn``."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    k = SPS_K
    r = np.random.RandomState(seed)
    rngw = np.random.RandomState(1)
    W = rngw.randn(k, INGEST_DIM) * (rngw.rand(k, INGEST_DIM) < 0.05)
    raw = r.randint(1, INGEST_DIM, size=(n, NNZ)).astype(np.int32)
    for _ in range(64):                   # resample intra-row collisions
        srt = np.sort(raw, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        if not dup.any():
            break
        raw[dup] = r.randint(1, INGEST_DIM, size=(int(dup.sum()), NNZ))
    logits = W[:, raw].sum(-1).T                          # (n, k)
    y = np.argmax(logits + r.gumbel(size=(n, k)), 1).astype(np.int64)
    target = logits[:, 0] - logits[:, 1] + 0.3 * r.randn(n)
    vecs = np.empty(n, object)
    ones = np.ones(NNZ)
    vecs[:] = [SparseVector(INGEST_DIM, raw[i], ones) for i in range(n)]
    return MTable({"label": y, "bin": (y < 2).astype(np.int64),
                   "target": target, "features": vecs},
                  "label LONG, bin LONG, target DOUBLE, "
                  "features SPARSE_VECTOR")


def served_predictor(table, req, dev):
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.serving import CompiledPredictor
    mapper = LinearModelMapper(table.schema, req.schema,
                               Params({"prediction_col": "pred",
                                       "vector_col": req.col_names[0]}))
    mapper.load_model(table)
    return CompiledPredictor(mapper, device=dev)


def op_coef_curve(op):
    """A linear train op's model coefficients and loss curve."""
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    return (LinearModelDataConverter.load_table(op.get_output_table()).coef,
            np.asarray(op.get_side_output(0).get_output_table().col("loss")))


def card_vs_cpu_f64(ks, kl, dev, name, train):
    """``train(where)`` -> (coef, loss curve) of a float64 training on
    ``where``. The card's run goes through B5 and P1 (the CPU's through
    their plain versions), its loss curve lies within rtol 1e-10 of the
    CPU's and its coefficients within 1e-10 of the CPU's largest; returns
    the gaps and times."""
    import torch
    ks.reset_launch_counts()
    kl.reset_launch_counts()
    t0 = time.perf_counter()
    gc, gl = train(dev)
    _sync(dev)
    card_s = time.perf_counter() - t0
    launches = {**ks.launch_counts(), **kl.launch_counts()}
    t0 = time.perf_counter()
    cc, cl = train("cpu")
    cpu_s = time.perf_counter() - t0
    if torch.device(dev).type == "cuda":
        require(launches["serve_sparse"] > 0 and launches["linear_grad"] > 0,
                f"{name}: the float64 card run launched B5 and P1: "
                f"{launches}")
    tiny = np.finfo(np.float64).tiny
    lgap = np.abs(gl - cl) / np.maximum(np.abs(cl), tiny)
    cgap = float(np.abs(gc - cc).max() / max(np.abs(cc).max(), tiny))
    require(gl.shape == cl.shape and bool((lgap <= 1e-10).all())
            and cgap <= 1e-10,
            f"{name}: the float64 card run within rtol 1e-10 of the CPU's "
            f"over {len(cl)} supersteps (loss {lgap.max()}, coefficients "
            f"{cgap} of the largest)")
    return {"supersteps": len(gl), "loss_first": float(cl[0]),
            "loss_last": float(cl[-1]), "loss_max_rel_gap": float(lgap.max()),
            "coef_max_gap_of_largest": cgap,
            "coef_max_abs": float(np.abs(cc).max()), "card_s": card_s,
            "cpu_s": cpu_s, "card_launches": launches}


def phase_softmax_sparse(ks, kl, dev, card, train, held):
    """16(b): ``SoftmaxTrainBatchOp`` on 100,000 Criteo-shape rows (k = 4,
    padded-COO: 2(k-1) B5 and (k-1) P1 launches a superstep, one plan a
    training), held in float64 against the CPU over 10 supersteps, and
    served on 8,192 held-out rows by ``CompiledPredictor`` (k - 1 B5
    launches a chunk)."""
    import torch
    from alink_tpu_torch.operator.batch.classification import \
        SoftmaxTrainBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    cuda = torch.device(dev).type == "cuda"
    ks.reset_launch_counts()
    kl.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with SuperstepClock(profile=SM_PROFILED if cuda else None) as clock:
        op = SoftmaxTrainBatchOp(vector_col="features", label_col="label",
                                 l2=1e-4, max_iter=SPS_STEPS, epsilon=0.0,
                                 device=dev).link_from(
            MemSourceBatchOp(train))
    _sync(dev)
    train_s = time.perf_counter() - t0
    launches = {**ks.launch_counts(), **kl.launch_counts()}
    per = clock.superstep_ms()
    traced = np.arange(SM_PROFILED[0] - 2, SM_PROFILED[1] - 1)
    ms = float(np.median(np.delete(per, traced)))
    kernel_share = {}
    if clock.prof is not None:
        kk = SM_PROFILED[1] - SM_PROFILED[0] + 1
        _, total, busy, by_name = clock.profiled(by_name=True)
        b5 = sum(v for k, v in by_name.items()
                 if "serve_sparse_kernel" in k) / kk
        p1 = sum(v for k, v in by_name.items() if "linear_grad_" in k) / kk
        kernel_share = {"device_ops_per_superstep": total / kk,
                        "device_busy_ms": busy / kk,
                        "device_busy_share": busy / kk / ms,
                        "b5_device_ms": b5, "p1_device_ms": p1,
                        "b5_p1_share_of_superstep": (b5 + p1) / ms}
    curve = np.asarray(op.get_side_output(0).get_output_table().col("loss"))
    steps = len(curve)
    require(steps == SPS_STEPS and np.isfinite(curve).all()
            and curve[-1] < curve[0], "the sparse Softmax loss fell over "
                                      "its fixed-length supersteps")
    want = {"serve_sparse": 2 * (SPS_K - 1) * steps,
            "linear_grad": (SPS_K - 1) * steps, "run_plan": 1}
    if cuda:
        require(all(launches[k] == v for k, v in want.items()),
                f"sparse Softmax launches 2(k-1) B5 and (k-1) P1 a "
                f"superstep and one plan: {launches} against {want}")
    # the training held to a reference: float64 on the card (B5 and P1 a
    # class column each, on one plan at the design's width) against the
    # CPU (their plain versions)
    f64 = card_vs_cpu_f64(ks, kl, dev, "sparse Softmax", lambda where: (
        op_coef_curve(SoftmaxTrainBatchOp(
            vector_col="features", label_col="label", l2=1e-4,
            max_iter=F64_STEPS, epsilon=0.0, device=where,
            dtype=torch.float64).link_from(MemSourceBatchOp(train)))))
    table = op.get_output_table()
    req = held.select(["features"])
    gpu = served_predictor(table, req, dev)
    ks.reset_launch_counts()
    band = softmax_labels_match(gpu, req, table, "sparse Softmax")
    serve_launches = ks.launch_counts()["serve_sparse"]
    chunks = -(-req.num_rows // gpu.buckets[-1])
    if cuda:
        require(serve_launches == chunks * (SPS_K - 1),
                f"sparse Softmax serving launches B5 once a class column "
                f"a chunk: {serve_launches}")
    pred = np.asarray(gpu.predict_table(req).col("pred"))
    acc = float((pred == np.asarray(held.col("label"))).mean())
    out = {"rows": train.num_rows, "k": SPS_K, "supersteps": steps,
           "train_s": train_s, "ms_per_superstep": ms,
           "samples_per_s": train.num_rows / ms * 1e3, **kernel_share,
           "loss_first": float(curve[0]), "loss_last": float(curve[-1]),
           "training_launches": launches,
           "launches_per_superstep": {k: launches[k] / steps for k in
                                      ("serve_sparse", "linear_grad")},
           "card_vs_cpu_f64": f64,
           "served_rows": req.num_rows, "rows_in_rounding_band": band,
           "serving_launches": serve_launches, "held_out_accuracy": acc}
    print(f"softmax (b) [{card}]: {train.num_rows} Criteo rows, k {SPS_K}: "
          f"{steps} supersteps in {train_s:.3f} s, {ms:.4f} ms a superstep, "
          f"{kernel_share}; launches {launches}; f64 card vs CPU {f64}; "
          f"served {req.num_rows} rows ({band} in the band, "
          f"{serve_launches} launches), held-out accuracy {acc}",
          flush=True)
    return out


FAMILY_OPS = (("LinearSvmTrainBatchOp", "bin", {}, False),
              ("PerceptronTrainBatchOp", "bin", {}, False),
              ("LinearRegTrainBatchOp", "target", {}, True),
              ("RidgeRegTrainBatchOp", "target", {"lambda_": 1e-3}, True),
              ("LassoRegTrainBatchOp", "target", {"lambda_": 1e-4}, True),
              ("LinearSvrTrainBatchOp", "target", {"tau": 0.1}, True))


def family_op(name):
    from alink_tpu_torch.operator.batch import classification, regression
    return getattr(classification, name, None) or getattr(regression, name)


def perceptron_warm(train, dev, dtype, steps):
    """The perceptron from a seeded warm start (``randn * 0.1``, seed 9:
    at zero its gradient vanishes): the train op's preparation, L-BFGS
    through ``optimize``, its model table. Returns (table, coef, curve)."""
    from alink_tpu_torch.operator.common.linear.base import (
        LinearModelDataConverter, prepare_linear_train)
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    op = family_op("PerceptronTrainBatchOp")(
        vector_col="features", label_col="bin", device=dev, dtype=dtype)
    prep = prepare_linear_train(train, op, "Perceptron")
    w0 = np.random.RandomState(9).randn(prep.dim) * 0.1
    coef, curve, _ = opt.optimize(prep.objective(0.0, 0.0), prep.train,
                                  opt.OptimParams(method="LBFGS",
                                                  max_iter=steps,
                                                  epsilon=0.0),
                                  prep.env, warm_start=w0)
    table, _ = prep.finish(coef, curve)
    return table, LinearModelDataConverter.load_table(table).coef, \
        np.asarray(curve)


def phase_family(ks, kl, dev, card, train, held):
    """16(c): the binary and regression types on the same Criteo rows,
    each trained through its op, held in float64 against the CPU over 10
    supersteps (the perceptron from a seeded warm start) and served by
    ``CompiledPredictor`` against ``map_table``; Newton on a dense binary
    task at 785 columns (float64 card vs CPU); SGD at
    ``mini_batch_fraction`` 0.1 (two card runs bitwise)."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    req = held.select(["features"])
    src = MemSourceBatchOp(train)
    out = {"ops": {}}
    for name, label, extra, regression in FAMILY_OPS:
        ks.reset_launch_counts()
        kl.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        op = family_op(name)(vector_col="features", label_col=label,
                             max_iter=FAMILY_STEPS, device=dev,
                             **extra).link_from(src)
        _sync(dev)
        secs = time.perf_counter() - t0
        launches = {**ks.launch_counts(), **kl.launch_counts()}
        curve = np.asarray(op.get_side_output(0).get_output_table()
                           .col("loss"))
        require(np.isfinite(curve).all(), f"{name}: finite losses")
        if torch.device(dev).type == "cuda":
            require(launches["serve_sparse"] > 0
                    and launches["linear_grad"] > 0,
                    f"{name} launched B5 and P1: {launches}")
        table = op.get_output_table()
        check = {}
        if name == "PerceptronTrainBatchOp":
            # from zero the perceptron stops after one superstep with an
            # all-zero model, as in the JAX package: serve one trained
            # from a seeded warm start instead
            table, _, wcurve = perceptron_warm(train, dev, torch.float32,
                                               FAMILY_STEPS)
            check["served_model"] = {"warm_start": "randn * 0.1, seed 9",
                                     "loss_first": float(wcurve[0]),
                                     "loss_last": float(wcurve[-1])}
        gpu = served_predictor(table, req, dev)
        ks.reset_launch_counts()
        if regression:
            check["worst_gap_of_band"] = served_scores_match(gpu, req, table,
                                                             name)
        else:
            _, band = served_labels_match(gpu, req, table, name)
            require(band < req.num_rows // 2,
                    f"{name}: most served labels are compared ({band} of "
                    f"{req.num_rows} rows in the rounding band)")
            check["rows_in_rounding_band"] = band
        out["ops"][name] = {"supersteps": len(curve), "train_s": secs,
                            "loss_first": float(curve[0]),
                            "loss_last": float(curve[-1]),
                            "training_launches": launches,
                            "serving_launches": ks.launch_counts(), **check}
        print(f"family (c) [{card}] {name}: {len(curve)} supersteps in "
              f"{secs:.3f} s, loss {curve[0]} -> {curve[-1]}, launches "
              f"{launches}, serving {ks.launch_counts()} {check}",
              flush=True)
    # the trainings held to a reference: float64 on the card (B5 and P1)
    # against the CPU (their plain versions)
    out["f64"] = {}
    for name, label, extra, _ in FAMILY_OPS:
        if name == "PerceptronTrainBatchOp":
            def fit(where):
                return perceptron_warm(train, where, torch.float64,
                                       F64_STEPS)[1:]
        else:
            def fit(where, name=name, label=label, extra=extra):
                return op_coef_curve(family_op(name)(
                    vector_col="features", label_col=label,
                    max_iter=F64_STEPS, epsilon=0.0, device=where,
                    dtype=torch.float64, **extra).link_from(src))
        out["f64"][name] = card_vs_cpu_f64(ks, kl, dev, name, fit)
        print(f"family (c) [{card}] {name}: f64 card vs CPU "
              f"{out['f64'][name]}", flush=True)
    # Newton: the dense Hessian and torch.linalg.solve, bench_softmax's
    # first rows as class 0 against the rest
    X, yc = softmax_data()
    m = SM_F64_ROWS
    runs = {}
    for where in (dev, "cpu"):
        data = {"X": torch.from_numpy(X[:m].astype(np.float64)).to(where),
                "y": torch.from_numpy(np.where(yc[:m] == 0, 1.0, -1.0))
                .to(where), "w": torch.ones(m, dtype=torch.float64,
                                            device=where)}
        obj = ob.UnaryLossObjFunc(ob.LogLossFunc(), X.shape[1], l2=SM_L2,
                                  reg_free_head=1)
        _sync(where)
        t0 = time.perf_counter()
        runs[where] = opt.optimize(obj, data, opt.OptimParams(
            method="NEWTON", max_iter=NEWTON_STEPS, epsilon=0.0),
            MLEnvironment(device=where)) + (time.perf_counter() - t0,)
    (gc, gl, gn, gs), (cc, cl, cn, cs) = runs[dev], runs["cpu"]
    lgap = np.abs(gl - cl) / np.abs(cl)
    cgap = np.abs(gc - cc) / np.abs(cc).max()
    require(gn == cn == NEWTON_STEPS and bool((lgap <= 1e-10).all())
            and bool((cgap <= 1e-10).all()),
            f"Newton float64 card within rtol 1e-10 of the CPU (loss "
            f"{lgap.max()}, coef {cgap.max()})")
    out["newton"] = {"rows": m, "cols": X.shape[1], "supersteps": gn,
                     "card_s": gs, "cpu_s": cs,
                     "loss_max_rel_gap": float(lgap.max()),
                     "coef_max_rel_gap": float(cgap.max()),
                     "loss_last": float(gl[-1])}
    # SGD at a tenth of the rows a superstep: two card runs bitwise
    tables = []
    for _ in range(2):
        op = family_op("LinearSvmTrainBatchOp")(
            vector_col="features", label_col="bin", optim_method="SGD",
            mini_batch_fraction=SGD_FRACTION, max_iter=FAMILY_STEPS,
            device=dev).link_from(src)
        tables.append(op.get_output_table().to_rows())
    require(tables[0] == tables[1], "two SGD card runs give the same "
                                    "model table")
    out["sgd"] = {"fraction": SGD_FRACTION, "supersteps": FAMILY_STEPS,
                  "two_runs_bitwise": True}
    print(f"family (c) [{card}]: Newton f64 card vs CPU loss gap "
          f"{lgap.max()}, coef gap {cgap.max()} ({gs:.3f} s card, {cs:.3f} "
          f"s CPU); SGD at {SGD_FRACTION} two runs bitwise", flush=True)
    return out


def iris_rows(seed=0):
    """bench.py::bench_kmeans's data (:565-572) without scikit-learn:
    150 iris-shaped base rows (50 a class from a seeded normal with that
    class's mean and standard deviation), tiled 10,000 times plus 0.05
    ``randn`` noise (``RandomState(0)``, as bench.py), float32."""
    rng = np.random.RandomState(seed)
    base = np.concatenate([rng.randn(50, 4) * np.asarray(s) + np.asarray(m)
                           for m, s in zip(IRIS_MEANS, IRIS_STDS)])
    base = base.astype(np.float32)
    noise = np.random.RandomState(0)
    return np.tile(base, (KM_REPS, 1)) + noise.randn(
        150 * KM_REPS, 4).astype(np.float32) * KM_NOISE


def kmeans_run(X, steps, dev, tol=0.0, init="RANDOM", health=None):
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.clustering.kmeans import \
        kmeans_train
    _sync(dev)
    t0 = time.perf_counter()
    C, w, n = kmeans_train(X, k=KM_K, max_iter=steps, tol=tol, init=init,
                           seed=0, env=MLEnvironment(device=dev),
                           health=health)
    return np.asarray(C), np.asarray(w), n, time.perf_counter() - t0


def phase_kmeans(dev, card):
    """16(d): bench_kmeans at its full shape on the card: 200 timed Lloyd
    supersteps (ms, samples/s, busy share), iterations to converge, two
    runs bitwise, float64 card vs CPU over 20 iterations with equal
    assignments, ``KMeansPredictBatchOp`` card vs CPU, and
    ``dryrun_multichip``'s KMeans leg."""
    import torch
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.clustering import (
        KMeansModelData, KMeansModelDataConverter, KMeansPredictBatchOp,
        KMeansTrainBatchOp)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.clustering.kmeans import \
        assign_clusters
    cuda = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    X = iris_rows()
    n = X.shape[0]
    out = {"rows": n, "cols": 4, "k": KM_K, "data_s": time.perf_counter() - t0}
    kmeans_run(X, 3, dev)                                 # warm-up
    with SuperstepClock(profile=KM_PROFILED if cuda else None) as clock:
        _, _, steps, secs = kmeans_run(X, KM_TIMED_STEPS, dev)
    require(steps == KM_TIMED_STEPS, f"KMeans ran {steps} supersteps")
    per = clock.superstep_ms()
    traced = np.arange(KM_PROFILED[0] - 2, KM_PROFILED[1] - 1)
    ms = float(np.median(np.delete(per, traced)))
    out.update(ms_per_superstep=ms, superstep_ms_min=float(per.min()),
               superstep_ms_max=float(per.max()), run_s=secs,
               samples_per_s=n / ms * 1e3)
    if clock.prof is not None:
        kk = KM_PROFILED[1] - KM_PROFILED[0] + 1
        _, total, busy = clock.profiled()
        out.update(device_ops_per_superstep=total / kk,
                   device_busy_ms=busy / kk,
                   device_busy_share=busy / kk / ms)
    _, _, n_rand, s_rand = kmeans_run(X, KM_CONVERGE_MAX, dev, tol=1e-4)
    _, _, n_par, s_par = kmeans_run(X, KM_CONVERGE_MAX, dev, tol=1e-4,
                                    init="K_MEANS_PARALLEL")
    out.update(iters_to_converge_random=n_rand, converge_random_s=s_rand,
               iters_to_converge_parallel=n_par, converge_parallel_s=s_par)
    a = kmeans_run(X, KM_CHECK_STEPS, dev)
    b = kmeans_run(X, KM_CHECK_STEPS, dev)
    require(np_bits_equal(a[0], b[0]) and np_bits_equal(a[1], b[1]),
            "two float32 card runs give bitwise-equal centroids")
    X64 = X.astype(np.float64)
    gc, _, _, _ = kmeans_run(X64, KM_CHECK_STEPS, dev)
    cc, _, _, cpu_s = kmeans_run(X64, KM_CHECK_STEPS, "cpu")
    gap = np.abs(gc - cc) / np.abs(cc)
    ids = [assign_clusters(torch.from_numpy(X64).to(where),
                           torch.tensor(c, device=where))[0].cpu().numpy()
           for where, c in ((dev, gc), ("cpu", cc))]
    require(bool((gap <= 1e-10).all()) and np.array_equal(*ids),
            f"float64 card centroids within rtol 1e-10 of the CPU's over "
            f"{KM_CHECK_STEPS} iterations ({gap.max()}), equal "
            f"assignments")
    # KMeansPredictBatchOp on the card against the CPU's, on the float64
    # model
    model = KMeansModelDataConverter().save_model(KMeansModelData(
        gc, np.ones(KM_K), "EUCLIDEAN", None, ["x0", "x1", "x2", "x3"]))
    table = MTable({f"x{j}": X64[:, j] for j in range(4)},
                   "x0 DOUBLE, x1 DOUBLE, x2 DOUBLE, x3 DOUBLE")
    pp = dict(prediction_col="cid", prediction_distance_col="dist")
    got = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        got[where] = KMeansPredictBatchOp(device=where, **pp).link_from(
            MemSourceBatchOp(model), MemSourceBatchOp(table)) \
            .get_output_table()
        got[where + "_s"] = time.perf_counter() - t0
    # the distance is sqrt(x2 - 2 x.c + c2): its square carries the
    # products' rounding, about eps (x2 + 2|x||c| + c2), which the
    # subtraction does not shrink
    dc, dh = (np.asarray(got[w].col("dist"), np.float64)
              for w in (dev, "cpu"))
    dgap = np.abs(dc - dh)
    dist_rel = float((dgap / np.maximum(dh, 1e-300)).max())
    cid = np.asarray(got["cpu"].col("cid"))
    xn = np.sqrt((X64 ** 2).sum(1))
    cn = np.sqrt((gc[cid] ** 2).sum(1))
    sq_band = float((np.abs(dc ** 2 - dh ** 2) / (
        np.finfo(np.float64).eps * (xn + cn) ** 2)).max())
    require(np.array_equal(np.asarray(got[dev].col("cid")), cid)
            and sq_band <= 8.0,
            f"KMeansPredictBatchOp on the card equals the CPU's: the ids, "
            f"and the squared distances within 8 eps (|x| + |c|)^2 "
            f"({sq_band} eps of it; distances rel {dist_rel})")
    # dryrun_multichip's leg: the operator on two columns, the default
    # (k-means||) init
    rng = np.random.RandomState(0)
    pts = rng.randn(256, 2)
    km = KMeansTrainBatchOp(feature_cols=["x0", "x1"], k=2, max_iter=3,
                            device=dev).link_from(MemSourceBatchOp(
                                [[float(a), float(b)] for a, b in pts],
                                "x0 DOUBLE, x1 DOUBLE"))
    kmd = KMeansModelDataConverter().load_model(km.get_output_table())
    require(kmd.centroids.shape == (2, 2)
            and np.isfinite(kmd.centroids).all()
            and kmd.weights.sum() == 256, "dryrun_multichip's KMeans leg")
    out.update(two_runs_bitwise=True, card_vs_cpu_f64={
        "iterations": KM_CHECK_STEPS, "centroid_max_rel_gap": float(
            gap.max()), "cpu_s": cpu_s, "assignments_equal": True},
        predict={"rows": n, "ids_equal": True,
                 "distance_max_rel_gap": dist_rel,
                 "squared_distance_gap_eps": sq_band,
                 "distances_bitwise": bool((dgap == 0).all()),
                 "card_s": got[dev + "_s"], "cpu_s": got["cpu_s"]},
        dryrun_leg={"centroids": kmd.centroids.tolist(),
                    "weights": kmd.weights.tolist()})
    print(f"kmeans (d) [{card}]: {n} x 4, k {KM_K}: {ms:.4f} ms a superstep "
          f"(median of {len(per) - len(traced)}), {out['samples_per_s']:.1f} "
          f"samples/s, busy {out.get('device_busy_share')}; converge "
          f"{n_rand} (RANDOM) / {n_par} (K_MEANS_PARALLEL) iterations; two "
          f"runs bitwise; f64 card vs CPU {gap.max()}; predict card vs CPU "
          f"distances rel {dist_rel} (squared {sq_band} eps); dryrun leg "
          f"{kmd.weights}",
          flush=True)
    return out


def phase_family_main(kernels, card, dev=None):
    """16: the rest of the linear family and KMeans on the card.
    ``kernels`` are the ``serve`` and ``linear`` kernel modules."""
    import torch
    ks, kl = kernels
    dev = "cuda" if dev is None else dev
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is off for the dense products")
    out = {"card": card}
    t0 = time.perf_counter()
    out["softmax_dense"] = phase_softmax_dense(ks, dev, card)
    t1 = time.perf_counter()
    train = criteo_softmax_rows(7, SPS_ROWS)
    held = criteo_softmax_rows(8, SPS_HELD)
    out["rows_s"] = time.perf_counter() - t1
    out["softmax_sparse"] = phase_softmax_sparse(ks, kl, dev, card, train,
                                                 held)
    out["family"] = phase_family(ks, kl, dev, card, train, held)
    out["kmeans"] = phase_kmeans(dev, card)
    out["seconds"] = time.perf_counter() - t0
    launches = {"serve_sparse": 0, "linear_grad": 0, "serve_dense": 0,
                "run_plan": 0}
    parts = [out["softmax_sparse"]["training_launches"],
             {"serve_sparse": out["softmax_sparse"]["serving_launches"]},
             out["softmax_dense"]["served"]["launches"]]
    for rec in out["family"]["ops"].values():
        parts += [rec["training_launches"], rec["serving_launches"]]
    for p in parts:
        for k in launches:
            launches[k] += p.get(k, 0)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# 17. durability: kill-and-resume on the card
# ---------------------------------------------------------------------------

DUR_STEPS, DUR_EVERY, DUR_KILL = 12, 4, 8        # (a) L-BFGS
DUR_SAMPLE_BATCHES, DUR_SAMPLE_EVERY, DUR_SAMPLE_KILL = 8, 2, 5
DUR_STREAM_EVERY, DUR_STREAM_KILL = 4, 9         # (b) bench_ftrl's stream
DUR_KM_STEPS, DUR_KM_EVERY, DUR_KM_KILL = 8, 2, 4


def killed(spec, site, run):
    """Run ``run()`` with ``spec`` armed in process: the armed site must
    raise ``FaultInjected``; any other exception propagates (and fails the
    script), and no raise fails it too."""
    from alink_tpu_torch.common.faults import FaultInjected, scoped_fault_env
    with scoped_fault_env(spec):
        try:
            run()
        except FaultInjected as e:
            require(e.site == site, f"the fault fired at {site}: {e}")
            return
    require(False, f"{spec} raised no FaultInjected")


def _ckpt_tags(d):
    from alink_tpu_torch.common.checkpoint import (checkpoint_tag,
                                                   list_checkpoints)
    return [checkpoint_tag(p) for p in list_checkpoints(d)]


def _array_digests(d):
    """{tag: blake2b of every array file} of a checkpoint directory."""
    import hashlib
    from alink_tpu_torch.common.checkpoint import (checkpoint_tag,
                                                   list_checkpoints)
    out = {}
    for p in list_checkpoints(d):
        out[checkpoint_tag(p)] = [
            hashlib.blake2b(Path(p, f).read_bytes(), digest_size=16)
            .hexdigest() for f in sorted(os.listdir(p)) if f.endswith(".npy")]
    return out


def _counts(*mods):
    return {k: v for m in mods for k, v in m.launch_counts().items()}


def _reset(*mods):
    for m in mods:
        m.reset_launch_counts()


def durability_lbfgs(ks, kl, root, card):
    """17(a): L-BFGS at bench_logreg's field-blocked shape, 12 supersteps
    at epsilon 0: plain, then for each writer (async on, off) checkpointed
    every 4, killed at superstep 8 and resumed; every result bitwise the
    plain one's, the two writers' snapshot files equal, the resumed run's
    launches those of supersteps 9-12 of the uninterrupted one plus one
    plan."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.engine import recovery
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
    fb, y = fb_criteo(0)
    data = {"fb_idx": fb, "y": y, "w": np.ones(LR_ROWS, np.float32)}
    meta = FieldBlockMeta(LR_FIELDS + 1, LR_FIELD_SIZE)
    w0 = (np.random.RandomState(123).randn(meta.dim) * 1e-6).astype(
        np.float32)

    def run(**ck):
        obj = ob.UnaryLossObjFunc(ob.LogLossFunc(), meta.dim, l2=LR_L2,
                                  reg_free_head=LR_FIELD_SIZE, fb_meta=meta)
        with SuperstepClock() as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coef, curve, n = opt.optimize(obj, data, opt.OptimParams(
                method="LBFGS", max_iter=DUR_STEPS, epsilon=0.0, **ck),
                MLEnvironment(device="cuda"), warm_start=w0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return (coef, curve, n), secs, clock.superstep_ms()

    def same(a, b):
        return (a[2] == b[2] and np_bits_equal(a[0], b[0])
                and np_bits_equal(a[1], b[1]))

    run()                                              # warm-up
    plain, plain_s, plain_ms = run()
    require(plain[2] == DUR_STEPS, f"L-BFGS ran {plain[2]} supersteps")
    out = {"rows": LR_ROWS, "fields": LR_FIELDS + 1,
           "field_size": LR_FIELD_SIZE, "supersteps": DUR_STEPS,
           "every": DUR_EVERY, "kill_at": DUR_KILL,
           "plain_s": plain_s,
           "plain_ms_per_superstep": float(plain_ms.mean()),
           "writers": {}}
    resumed_launches = None
    for flag in ("1", "0"):
        os.environ["ALINK_TPU_ASYNC_SNAPSHOT"] = flag
        try:
            full_dir, kill_dir = (str(root / f"lbfgs-{k}-{flag}")
                                  for k in ("full", "kill"))
            ck = dict(checkpoint_dir=full_dir, checkpoint_every=DUR_EVERY)
            recovery.reset_snapshot_records()
            _reset(ks, kl)
            full, full_s, full_ms = run(**ck)
            full_launches = _counts(ks, kl)
            saves = [r for r in recovery.snapshot_records()
                     if r["what"] == "save"]
            require(_ckpt_tags(full_dir) == [4, 8, 12],
                    f"snapshots at 4, 8, 12: {_ckpt_tags(full_dir)}")
            ck = dict(checkpoint_dir=kill_dir, checkpoint_every=DUR_EVERY)
            _reset(ks, kl)
            killed(f"comqueue.superstep:{DUR_KILL}", "comqueue.superstep",
                   lambda: run(**ck))
            kill_launches = _counts(ks, kl)
            require(_ckpt_tags(kill_dir) == [4], f"only ckpt-4 survives "
                    f"the kill at {DUR_KILL}: {_ckpt_tags(kill_dir)}")
            recovery.reset_snapshot_records()
            _reset(ks, kl)
            res, res_s, _ = run(resume_from=kill_dir, **ck)
            res_launches = _counts(ks, kl)
            loads = [r for r in recovery.snapshot_records()
                     if r["what"] == "load"]
            require(same(full, plain) and same(res, plain),
                    f"writer {flag}: checkpointed and resumed L-BFGS "
                    f"bitwise the plain run's coefficients, loss curve and "
                    f"step count")
            # supersteps 9-12 of the uninterrupted run issue what 9-12
            # of the killed one would have: 2 x (full - killed)
            # (supersteps 9-12 minus 5-8's) per kernel, plus the plan
            per4 = {k: full_launches[k] - kill_launches[k]
                    for k in full_launches}
            want = {k: 2 * v for k, v in per4.items()}
            want["run_plan"] += 1
            require(res_launches == want,
                    f"the resumed run's launches {res_launches} are 8 "
                    f"supersteps' of the uninterrupted run plus one plan "
                    f"({want})")
            for k in ("linear_grad", "serve_sparse", "run_plan"):
                require(res_launches[k] > 0, f"the resumed L-BFGS launched "
                                             f"{k}")
            resumed_launches = res_launches
            out["writers"]["async" if flag == "1" else "sync"] = {
                "checkpointed_s": full_s,
                "checkpointed_ms_per_superstep": float(full_ms.mean()),
                "overhead": float(full_ms.mean() / plain_ms.mean() - 1.0),
                "snapshots": [{"step": r["tag"], "fetch_ms": r["fetch_ms"],
                               "write_ms": r["write_ms"],
                               "mb": r["bytes"] / 1e6} for r in saves],
                "resume_load_ms": loads[0]["load_ms"], "resumed_s": res_s,
                "launches_full": full_launches,
                "launches_resumed": res_launches,
                "digests": _array_digests(full_dir)}
        finally:
            os.environ.pop("ALINK_TPU_ASYNC_SNAPSHOT", None)
    w = out["writers"]
    require(w["async"].pop("digests") == w["sync"].pop("digests"),
            "the async and sync writers wrote the same snapshot arrays")
    out["launches"] = resumed_launches
    for name, rec in w.items():
        print(f"durability (a) [{card}]: {name} writer: "
              f"{rec['checkpointed_ms_per_superstep']:.4f} ms a superstep "
              f"checkpointed every {DUR_EVERY} vs "
              f"{out['plain_ms_per_superstep']:.4f} plain (overhead "
              f"{rec['overhead']:+.4f}); snapshots " + ", ".join(
                  f"{s['step']}: {s['fetch_ms']:.3f} + {s['write_ms']:.3f} "
                  f"ms, {s['mb']:.3f} MB" for s in rec["snapshots"])
              + f"; resume load {rec['resume_load_ms']:.3f} ms; "
              f"launches resumed {rec['launches_resumed']}", flush=True)
    return out


def durability_ftrl_sample(kf, root, card):
    """17(b), strict drain: ``update_mode="sample"`` on Criteo-shape rows
    at 2^20 features, 8 micro-batches of 4096, checkpointed every 2,
    killed after micro-batch 5 and restarted: the final model bitwise the
    uninterrupted drain's; the checkpoint's ms and MB at 2^20 + 1 slots
    beside the JSON model snapshot's ms (H1)."""
    import torch
    from alink_tpu_torch.common.checkpoint import (latest_checkpoint,
                                                   load_checkpoint)
    from alink_tpu_torch.engine import recovery
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    rows = criteo_ftrl_rows(11, DUR_SAMPLE_BATCHES * FTRL_BATCH)
    warm = ftrl_warm_model(np.random.default_rng(11))
    d = str(root / "ftrl-sample")

    def drain(**ck):
        op = ftrl_op(warm, "sample", time_interval=1e9, **ck).link_from(
            MemSourceStreamOp(rows, batch_size=FTRL_BATCH))
        snaps, secs = drain_timed(op)
        require(len(snaps) == 1, "one snapshot, at the end")
        return op, _coefs(snaps[-1][1]), secs

    _, base, base_s = drain()
    ck = dict(checkpoint_dir=d, checkpoint_every_batches=DUR_SAMPLE_EVERY)
    recovery.reset_snapshot_records()
    killed(f"ftrl.batch:{DUR_SAMPLE_KILL}", "ftrl.batch",
           lambda: drain(**ck))
    saves = [r for r in recovery.snapshot_records() if r["what"] == "save"]
    require(_ckpt_tags(d) == [2, 4], f"ckpt-2 and ckpt-4 survive the kill "
                                     f"after batch 5: {_ckpt_tags(d)}")
    recovery.reset_snapshot_records()
    _reset(kf)
    op, res, res_s = drain(**ck)
    launches = _counts(kf)
    loads = [r for r in recovery.snapshot_records() if r["what"] == "load"]
    require(np_bits_equal(res, base), "the resumed strict drain's model "
                                      "bitwise the uninterrupted one's")
    micro = DUR_SAMPLE_BATCHES - 4
    chunks = micro * FTRL_BATCH // 4
    require(launches["ftrl_gather_pair"] == chunks
            and launches["ftrl_walk"] == chunks
            and launches["ftrl_scatter_add"] == 2 * chunks,
            f"the resumed drain ran micro-batches 5-8 on B1-B3: {launches}")
    # the JSON model snapshot of the same state (H1), timed alone
    payload, _ = load_checkpoint(latest_checkpoint(d))
    z = torch.from_numpy(payload["z"]).cuda()
    n = torch.from_numpy(payload["n"]).cuda()
    op.trainer.snapshot(z, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op.trainer.snapshot(z, n)
    json_ms = (time.perf_counter() - t0) * 1e3
    out = {"rows": DUR_SAMPLE_BATCHES * FTRL_BATCH, "micro_batch": FTRL_BATCH,
           "slots": FEATURES + 1, "every": DUR_SAMPLE_EVERY,
           "kill_after": DUR_SAMPLE_KILL, "drain_s": base_s,
           "resumed_s": res_s,
           "checkpoints": [{"batch": r["tag"], "fetch_ms": r["fetch_ms"],
                            "write_ms": r["write_ms"],
                            "mb": r["bytes"] / 1e6} for r in saves],
           "resume_load_ms": loads[0]["load_ms"],
           "json_snapshot_ms": json_ms, "launches": launches}
    print(f"durability (b) strict [{card}]: {FEATURES + 1} slots: "
          + ", ".join(f"ckpt {c['batch']}: {c['fetch_ms']:.3f} + "
                      f"{c['write_ms']:.3f} ms, {c['mb']:.3f} MB"
                      for c in out["checkpoints"])
          + f"; JSON model snapshot {json_ms:.3f} ms; resume load "
          f"{out['resume_load_ms']:.3f} ms; drain {base_s:.3f} s, resumed "
          f"{res_s:.3f} s; launches {launches}", flush=True)
    return out


def durability_ftrl_stream(kl, kf, root, card):
    """17(b), batch drain: bench_ftrl's stream as phase 14 runs it
    (262,144 rows hashed field-aware into 3 x 1648, 16,384-row
    micro-batches, the field-blocked program), checkpointed every 4,
    killed after micro-batch 9 of 16 and restarted: the final model
    bitwise the uninterrupted drain's."""
    from alink_tpu_torch.engine import recovery
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.feature.feature_ops import \
        FeatureHasherBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlTrainStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    table = bench_stream_data()
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="click",
        max_iter=ST_WARM_ITER).link_from(FeatureHasherBatchOp(
            **ST_HASH).link_from(MemSourceBatchOp(
                table.first_n(ST_WARM_ROWS))))
    warm.get_output_table()
    d = str(root / "ftrl-stream")
    micro = ST_ROWS // ST_MICRO

    def drain(**ck):
        feat = FeatureHasherStreamOp(**ST_HASH).link_from(
            MemSourceStreamOp(table, batch_size=ST_MICRO))
        op = FtrlTrainStreamOp(
            warm, vector_col="vec", label_col="click", update_mode="batch",
            time_interval=1e9, **FTRL_HP, **ck).link_from(feat)
        snaps, secs = drain_timed(op)
        require(len(snaps) == 1, "one snapshot, at the end")
        return _coefs(snaps[-1][1]), secs

    base, base_s = drain()
    ck = dict(checkpoint_dir=d, checkpoint_every_batches=DUR_STREAM_EVERY)
    recovery.reset_snapshot_records()
    killed(f"ftrl.batch:{DUR_STREAM_KILL}", "ftrl.batch",
           lambda: drain(**ck))
    saves = [r for r in recovery.snapshot_records() if r["what"] == "save"]
    require(_ckpt_tags(d) == [4, 8], f"ckpt-4 and ckpt-8 survive the kill "
                                     f"after batch 9: {_ckpt_tags(d)}")
    recovery.reset_snapshot_records()
    _reset(kl, kf)
    res, res_s = drain(**ck)
    launches = _counts(kl, kf)
    loads = [r for r in recovery.snapshot_records() if r["what"] == "load"]
    require(np_bits_equal(res, base), "the resumed stream's model bitwise "
                                      "the uninterrupted one's")
    left = micro - 8
    require(launches["scatter_walk"] == left and launches["run_plan"] == left
            and launches["ftrl_gather_pair"] == left
            and launches["linear_grad"] == 0,
            f"the resumed stream ran micro-batches 9-16 field-blocked: one "
            f"gather_pair, plan and scatter_walk each ({launches})")
    out = {"rows": ST_ROWS, "micro_batch": ST_MICRO, "every":
           DUR_STREAM_EVERY, "kill_after": DUR_STREAM_KILL,
           "drain_s": base_s, "resumed_s": res_s,
           "checkpoints": [{"batch": r["tag"], "fetch_ms": r["fetch_ms"],
                            "write_ms": r["write_ms"],
                            "mb": r["bytes"] / 1e6} for r in saves],
           "resume_load_ms": loads[0]["load_ms"], "launches": launches}
    print(f"durability (b) stream [{card}]: " + ", ".join(
        f"ckpt {c['batch']}: {c['fetch_ms']:.3f} + {c['write_ms']:.3f} ms, "
        f"{c['mb']:.4f} MB" for c in out["checkpoints"])
        + f"; resume load {out['resume_load_ms']:.3f} ms; drain "
        f"{base_s:.3f} s, resumed {res_s:.3f} s; launches {launches}",
        flush=True)
    return out


def durability_kmeans(root, card):
    """17(c): KMeans at bench_kmeans' shape (1,500,000 x 4, k = 3, RANDOM,
    tol 0), 8 Lloyd supersteps checkpointed every 2, killed at 4 and
    resumed: centroids and weights bitwise the uninterrupted run's."""
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.engine import recovery
    from alink_tpu_torch.operator.common.clustering.kmeans import \
        kmeans_train
    X = iris_rows()
    d = str(root / "kmeans")

    def run(**ck):
        _sync("cuda")
        t0 = time.perf_counter()
        C, w, n = kmeans_train(X, k=KM_K, max_iter=DUR_KM_STEPS, tol=0.0,
                               init="RANDOM", seed=0,
                               env=MLEnvironment(device="cuda"), **ck)
        _sync("cuda")
        return (np.asarray(C), np.asarray(w), n), time.perf_counter() - t0

    base, base_s = run()
    ck = dict(checkpoint_dir=d, checkpoint_every=DUR_KM_EVERY)
    recovery.reset_snapshot_records()
    killed(f"comqueue.superstep:{DUR_KM_KILL}", "comqueue.superstep",
           lambda: run(**ck))
    saves = [r for r in recovery.snapshot_records() if r["what"] == "save"]
    require(_ckpt_tags(d) == [2], f"only ckpt-2 survives the kill at "
                                  f"{DUR_KM_KILL}: {_ckpt_tags(d)}")
    recovery.reset_snapshot_records()
    res, res_s = run(resume_from=d, **ck)
    loads = [r for r in recovery.snapshot_records() if r["what"] == "load"]
    require(res[2] == base[2] == DUR_KM_STEPS and np_bits_equal(res[0], base[0])
            and np_bits_equal(res[1], base[1]),
            "the resumed KMeans' centroids and weights bitwise the "
            "uninterrupted run's")
    out = {"rows": X.shape[0], "k": KM_K, "supersteps": DUR_KM_STEPS,
           "every": DUR_KM_EVERY, "kill_at": DUR_KM_KILL, "run_s": base_s,
           "resumed_s": res_s,
           "snapshots": [{"step": r["tag"], "fetch_ms": r["fetch_ms"],
                          "write_ms": r["write_ms"], "mb": r["bytes"] / 1e6}
                         for r in saves],
           "resume_load_ms": loads[0]["load_ms"]}
    print(f"durability (c) [{card}]: {X.shape[0]} x 4, k {KM_K}: run "
          f"{base_s:.3f} s, resumed {res_s:.3f} s; snapshots "
          + ", ".join(f"{s['step']}: {s['fetch_ms']:.3f} + "
                      f"{s['write_ms']:.3f} ms, {s['mb']:.4f} MB"
                      for s in out["snapshots"])
          + f"; resume load {out['resume_load_ms']:.3f} ms", flush=True)
    return out


def durability_corruption(root, card):
    """17(d): one array file of (a)'s killed-and-resumed directory
    corrupted: ``validate_checkpoint`` raises and ``latest_checkpoint``
    falls back to the older snapshot."""
    from alink_tpu_torch.common.checkpoint import (CheckpointError,
                                                   checkpoint_tag,
                                                   latest_checkpoint,
                                                   list_checkpoints,
                                                   validate_checkpoint)
    d = str(root / "lbfgs-kill-1")
    paths = list_checkpoints(d)
    require([checkpoint_tag(p) for p in paths] == [4, 8, 12],
            f"(a)'s resumed directory holds 4, 8, 12: {paths}")
    target = Path(paths[-1], "arr_00000.npy")
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    try:
        validate_checkpoint(paths[-1])
        require(False, "a corrupted snapshot validated")
    except CheckpointError as e:
        reason = str(e)
    fallback = checkpoint_tag(latest_checkpoint(d))
    require(fallback == 8, f"latest_checkpoint falls back to ckpt-8: "
                           f"{fallback}")
    print(f"durability (d) [{card}]: corrupted ckpt-12 refused "
          f"({reason.split(': ', 1)[-1][:60]}...), latest falls back to "
          f"ckpt-{fallback}", flush=True)
    return {"refused": True, "fallback_tag": fallback}


def phase_durability(kernels, card):
    """17: durability on the card. ``kernels`` are the ``serve``,
    ``linear`` and ``ftrl`` kernel modules. Snapshots go to a directory
    under ``tempfile.gettempdir()``, removed at the end."""
    import shutil
    import tempfile
    ks, kl, kf = kernels
    root = Path(tempfile.mkdtemp(prefix=f"alink-durability-{os.getpid()}-"))
    t0 = time.perf_counter()
    try:
        out = {"card": card}
        out["lbfgs"] = durability_lbfgs(ks, kl, root, card)
        out["ftrl_sample"] = durability_ftrl_sample(kf, root, card)
        out["ftrl_stream"] = durability_ftrl_stream(kl, kf, root, card)
        out["kmeans"] = durability_kmeans(root, card)
        out["corruption"] = durability_corruption(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    launches = {}
    for part in ("lbfgs", "ftrl_sample", "ftrl_stream"):
        for k, v in out[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out

# ---------------------------------------------------------------------------
# 18. ALS: bench_als and bench_als_large, the operators, the twins
# ---------------------------------------------------------------------------

ALS_RANK, ALS_LAMBDA = 10, 0.1
ALS_SHAPE = (6040, 3706, 1_000_000)              # MovieLens-1M (bench_als)
# MovieLens-10M (bench_als_large at ALINK_TPU_ALS_LARGE_NNZ's default)
ALS_LARGE_SHAPE = (69_878, 10_677, 10_000_000)
ALS_TIMED, ALS_LARGE_TIMED = 40, 8               # timed supersteps
ALS_PROFILED, ALS_LARGE_PROFILED = (5, 9), (3, 4)
ALS_SPLIT_STEPS, ALS_CHECK_STEPS, ALS_MODE_STEPS = 5, 5, 3
ALS_LARGE_RMSE_STEPS = 5                         # bench_als_large's short fit
# bench.py:1765-1767: a rating-iteration moves 2 half-sweeps x 6 passes
# over the (nnz, K) float32 contributions, K = r(r+1)/2 + r + 1 = 66
ALS_K = ALS_RANK * (ALS_RANK + 1) // 2 + ALS_RANK + 1
ALS_BYTES_PER_RATING = 2 * 6 * ALS_K * 4         # 3,168 B
# the JAX package's als_train at (a)'s shape (tol 1e-3, at most 30
# iterations) on a CPU: its RMSE curve, to 5 decimals; it stops after 10
ALS_JAX_CURVE = (0.51052, 0.50996, 0.50233, 0.47428, 0.43759, 0.41297,
                 0.39708, 0.38818, 0.38381, 0.38300)
# the figures' 5 decimals (5e-6) and the float32 sums' order over a
# million ratings and 10 supersteps
ALS_CURVE_ATOL = 5e-5
# card vs the port on the CPU: factors of their largest |value| and the
# curve relative, float32 in both (the prefix and the solve each keep
# about 1e-6; CUDA's and the CPU's sum orders differ)
ALS_CARD_CPU_TOL, ALS_CURVE_RTOL = 1e-4, 1e-5
# implicit preferences (alpha 40: weights up to 200, condition numbers in
# the thousands) amplify float32 rounding about 100x
# (tests/test_torch_als.py measures the JAX package's own float32-to-float64
# gap at 8.4e-4 to 1.8e-3 after 6 supersteps)
ALS_IMPLICIT_TOL = 5e-3
# the same case in float64: the card within rounding of the CPU (the
# float32 gap is then float32 rounding amplified by the conditioning)
ALS_IMPLICIT_F64_TOL = 1e-9
ALS_HELD, ALS_TOPK_USERS, ALS_TOPK, ALS_MICRO = 100_000, 1000, 10, 4096
TWIN_MICRO, TWIN_KM_ROWS, TWIN_EVAL_ROWS = 1024, 131_072, 20_000
ALS_STAGES = (("contributions", "gather_contributions"),
              ("prefix_sums", "prefix"), ("run_slots", "slots"),
              ("solve_normal", "solve"), ("train_rmse", "rmse"))


def als_data(U, I, nnz, rank=ALS_RANK):
    """bench.py::bench_als's ratings (:1708-1714, ``RandomState(0)``):
    (users, items, ratings float32, (uf_true, if_true), the generator
    after its draws)."""
    rng = np.random.RandomState(0)
    users = rng.randint(0, U, nnz).astype(np.int32)
    items = rng.randint(0, I, nnz).astype(np.int32)
    uf_true = rng.randn(U, rank).astype(np.float32) / np.sqrt(rank)
    if_true = rng.randn(I, rank).astype(np.float32) / np.sqrt(rank)
    ratings = ((uf_true[users] * if_true[items]).sum(1) * 1.5 + 3.5
               + 0.2 * rng.randn(nnz)).astype(np.float32)
    return users, items, ratings, (uf_true, if_true), rng


def als_run(data, U, I, steps, dev, dtype=None, **kw):
    """``als_train`` at rank 10, lambda 0.1 on ``dev`` (in ``dtype``,
    float32 when none is given): (uf, if_, curve, seconds)."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.recommendation.als import (
        AlsTrainParams, als_train)
    p = AlsTrainParams(rank=ALS_RANK, num_iter=steps, lambda_reg=ALS_LAMBDA,
                       **kw)
    _sync(dev)
    t0 = time.perf_counter()
    uf, if_, curve = als_train(data[0], data[1], data[2], p,
                               env=MLEnvironment(device=dev), num_users=U,
                               num_items=I, dtype=dtype or torch.float32)
    return uf, if_, curve, time.perf_counter() - t0


def als_rmse(uf, if_, users, items, ratings):
    """bench.py's training RMSE of final factors (:1741-1743)."""
    preds = (uf[users] * if_[items]).sum(1)
    return float(np.sqrt(((preds - ratings) ** 2).mean()))


class AlsClock(SuperstepClock):
    """A CUDA event at the end of each ALS superstep (after its RMSE, the
    superstep's last stage; at tol 0 the queue reads nothing back), and
    optionally ``torch.profiler`` over supersteps ``profile[0]`` to
    ``profile[1]``, with a synchronize at each edge."""

    def __enter__(self):
        import torch
        from alink_tpu_torch.operator.common.recommendation import als
        from torch.profiler import ProfilerActivity, profile
        self._mod, self._orig = als, als.train_rmse
        if self.profile is not None:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        clock, orig = self, self._orig

        def timed(*a, **kw):
            out = orig(*a, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            clock.stamps.append(ev)
            k = len(clock.stamps)
            if clock.prof is not None and k in (clock.profile[0] - 1,
                                                clock.profile[1]):
                torch.cuda.synchronize()
                if k == clock.profile[1]:
                    clock.prof.stop()
                else:
                    clock.prof.start()
            return out
        als.train_rmse = timed
        return self

    def __exit__(self, *exc):
        self._mod.train_rmse = self._orig

    def superstep_ms(self):
        """ms of supersteps 2..N by the events."""
        import torch
        torch.cuda.synchronize()
        return np.asarray([a.elapsed_time(b) for a, b in
                           zip(self.stamps, self.stamps[1:])])


class AlsStages(StageSplit):
    """Host-clock ms of each stage of the ALS superstep, each ending in a
    synchronize: the gather and contributions, the prefix, the run slots
    and the solve of both half-sweeps, and the RMSE."""

    def __enter__(self):
        from alink_tpu_torch.operator.common.recommendation import als
        self._mod = als
        self._saved = [(k, getattr(als, k)) for k, _ in ALS_STAGES]
        for k, fn in self._saved:
            setattr(als, k, self._timed(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self._saved:
            setattr(self._mod, k, fn)

    def medians(self):
        """Median ms a superstep of each stage (both half-sweeps summed),
        supersteps 2..N."""
        out = {}
        for k, name in ALS_STAGES:
            v = np.asarray(self.times[k])
            per = v.reshape(-1, 1 if k == "train_rmse" else 2).sum(1)
            out[name] = float(np.median(per[1:]))
        out["superstep_sum"] = sum(out.values())
        return out


def als_timing(data, U, I, timed, profile, dev):
    """ms a superstep by events (median of supersteps 2..timed), peak
    memory, device ops and busy share under the profiler, and the stage
    split of one shape."""
    import torch
    nnz = len(data[2])
    als_run(data, U, I, 2, dev)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    with AlsClock() as clock:
        _, _, curve, secs = als_run(data, U, I, timed, dev)
    require(len(curve) == timed and bool(np.isfinite(curve).all()),
            f"ALS ran {timed} finite supersteps")
    per = clock.superstep_ms()
    ms = float(np.median(per))
    bound = ALS_BYTES_PER_RATING * nnz / PEAK_BYTES_S * 1e3
    out = {"ratings": nnz, "users": U, "items": I, "rank": ALS_RANK,
           "timed_supersteps": timed, "run_s": secs, "ms_per_superstep": ms,
           "superstep_ms_min": float(per.min()),
           "superstep_ms_max": float(per.max()),
           "samples_per_s": nnz / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bound_ms": bound, "bound_by": "bytes",
           "bound_bytes_per_rating": ALS_BYTES_PER_RATING,
           "bound_fraction": bound / ms}
    with AlsClock(profile=profile) as pclock:
        _, _, pcurve, _ = als_run(data, U, I, profile[1] + 1, dev)
    kk = profile[1] - profile[0] + 1
    _, total, busy, by_name = pclock.profiled(by_name=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out.update(device_ops_per_superstep=total / kk,
               device_busy_ms=busy / kk, device_busy_share=busy / kk / ms,
               top_device_ms_per_superstep={k: v / kk for k, v in top})
    with AlsStages() as st:
        als_run(data, U, I, ALS_SPLIT_STEPS, dev)
    out["stages_ms"] = st.medians()
    return out, pcurve


def als_bench(data, dev, card):
    """18(a): bench_als's shape on the card."""
    U, I, nnz = ALS_SHAPE
    users, items, ratings, _, rng = data
    out, _ = als_timing(data, U, I, ALS_TIMED, ALS_PROFILED, dev)
    # the tol=1e-3 run bench.py reports (at most 30 iterations)
    uf, if_, curve, secs = als_run(data, U, I, 30, dev, tol=1e-3)
    rmse = als_rmse(uf, if_, users, items, ratings)
    ref = np.asarray(ALS_JAX_CURVE)
    gap = (float(np.abs(curve - ref).max()) if len(curve) == len(ref)
           else None)
    out.update(iters_to_converge=len(curve), converge_s=secs, rmse=rmse,
               rmse_curve=curve.tolist(), jax_curve_max_abs_gap=gap)
    require(len(curve) == len(ref) and gap <= ALS_CURVE_ATOL
            and abs(rmse - ref[-1]) <= ALS_CURVE_ATOL,
            f"the tol=1e-3 run stops after the JAX package's {len(ref)} "
            f"iterations ({len(curve)}) with its curve within "
            f"{ALS_CURVE_ATOL} ({gap}; training RMSE {rmse})")
    # two card runs bitwise; the card against the port on the CPU
    a = als_run(data, U, I, ALS_CHECK_STEPS, dev)
    b = als_run(data, U, I, ALS_CHECK_STEPS, dev)
    require(all(np_bits_equal(x, y) for x, y in zip(a[:3], b[:3])),
            "two card runs give bitwise-equal factors and curves")
    c = als_run(data, U, I, ALS_CHECK_STEPS, "cpu")
    fgap = max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(a[:2], c[:2]))
    cgap = float((np.abs(a[2] - c[2]) / c[2]).max())
    require(fgap <= ALS_CARD_CPU_TOL and cgap <= ALS_CURVE_RTOL,
            f"the card within {ALS_CARD_CPU_TOL} of the CPU's factors and "
            f"{ALS_CURVE_RTOL} of its curve over {ALS_CHECK_STEPS} "
            f"supersteps ({fgap}, {cgap})")
    out.update(two_runs_bitwise=True, card_vs_cpu={
        "supersteps": ALS_CHECK_STEPS, "factor_max_gap_of_largest": fgap,
        "curve_max_rel_gap": cgap, "cpu_s": c[3], "card_s": a[3]})
    # bench.py's host baseline: one numpy sweep of batched normal
    # equations (:1746-1761), drawn from the data generator after its draws
    rank = ALS_RANK
    ufc = rng.rand(U, rank).astype(np.float32)
    ifc = rng.rand(I, rank).astype(np.float32)
    eye = np.eye(rank, dtype=np.float32)
    t0 = time.perf_counter()
    for ids, oids, nrows, fac, ofac in ((users, items, U, ufc, ifc),
                                        (items, users, I, ifc, ufc)):
        x = ofac[oids]
        A = np.zeros((nrows, rank, rank), np.float32)
        bb = np.zeros((nrows, rank), np.float32)
        np.add.at(A, ids, x[:, :, None] * x[:, None, :])
        np.add.at(bb, ids, ratings[:, None] * x)
        fac[:] = np.linalg.solve(A + 0.1 * eye, bb[:, :, None])[:, :, 0]
    base_s = time.perf_counter() - t0
    out.update(host_baseline_s=base_s, host_baseline_samples_per_s=nnz
               / base_s, vs_baseline=out["samples_per_s"] * base_s / nnz,
               host_cpu=host_cpu())
    print(f"als (a) [{card}]: {U} x {I}, {nnz} ratings, rank {rank}: "
          f"{out['ms_per_superstep']:.4f} ms a superstep (median of "
          f"{ALS_TIMED - 1}; bound {out['bound_ms']:.4f} ms, "
          f"{out['bound_fraction']:.3f} of it), {out['samples_per_s']:.1f} "
          f"samples/s, {out['device_ops_per_superstep']} device ops a "
          f"superstep, busy {out['device_busy_share']:.3f}, peak "
          f"{out['peak_memory_gb']:.3f} GB; stages {out['stages_ms']}; top "
          f"ops {out['top_device_ms_per_superstep']}; tol 1e-3: "
          f"{len(curve)} iterations, RMSE {rmse} (curve {curve.tolist()}, "
          f"gap {gap}); two runs bitwise; card vs CPU {fgap} / {cgap}; "
          f"host sweep {base_s:.3f} s, vs_baseline {out['vs_baseline']:.1f}",
          flush=True)
    return out


def als_bench_large(dev, card):
    """18(b): bench_als_large's shape on the card."""
    U, I, nnz = ALS_LARGE_SHAPE
    t0 = time.perf_counter()
    data = als_data(U, I, nnz)
    data_s = time.perf_counter() - t0
    out, curve = als_timing(data, U, I, ALS_LARGE_TIMED, ALS_LARGE_PROFILED,
                            dev)
    # bench_als_large's quality anchor: a 5-iteration fit's RMSE (the
    # profiled run is that fit)
    require(len(curve) == ALS_LARGE_RMSE_STEPS and curve[-1] < curve[0],
            f"the 5-iteration fit's RMSE fell: {curve}")
    out.update(data_s=data_s, rmse_5=float(curve[-1]),
               rmse_curve=curve.tolist())
    print(f"als (b) [{card}]: {U} x {I}, {nnz} ratings: "
          f"{out['ms_per_superstep']:.4f} ms a superstep (median of "
          f"{ALS_LARGE_TIMED - 1}; bound {out['bound_ms']:.4f} ms, "
          f"{out['bound_fraction']:.3f} of it), {out['samples_per_s']:.1f} "
          f"samples/s, {out['device_ops_per_superstep']} device ops, busy "
          f"{out['device_busy_share']:.3f}, peak {out['peak_memory_gb']:.3f}"
          f" GB; stages {out['stages_ms']}; 5-iteration RMSE "
          f"{curve.tolist()}", flush=True)
    return out


def als_operators(data, dev, card):
    """18(c): the operator path at (a)'s ratings, and the implicit and
    nonnegative modes card vs CPU (the implicit one in float64 too)."""
    import torch
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.evaluation import \
        EvalRegressionBatchOp
    from alink_tpu_torch.operator.batch.recommendation import (
        AlsModelDataConverter, AlsPredictBatchOp, AlsTopKPredictBatchOp,
        AlsTrainBatchOp)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream import AlsPredictStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    U, I, nnz = ALS_SHAPE
    users, items, ratings, (uf_true, if_true), _ = data
    out = {}
    table = MTable({"user": users.astype(np.int64),
                    "item": items.astype(np.int64),
                    "rating": ratings.astype(np.float64)},
                   "user LONG, item LONG, rating DOUBLE")
    t0 = time.perf_counter()
    train = AlsTrainBatchOp(user_col="user", item_col="item",
                            rate_col="rating", rank=ALS_RANK, num_iter=10,
                            lambda_=ALS_LAMBDA, device=dev).link_from(
        MemSourceBatchOp(table))
    out["train_op_s"] = time.perf_counter() - t0
    side = train.get_side_output(0).get_output_table()
    out["train_rmse"] = np.asarray(side.col("train_rmse")).tolist()
    # 100,000 held-out pairs; about 2 % of the users and items unknown
    r = np.random.RandomState(11)
    hu = r.randint(0, U + U // 50, ALS_HELD)
    hi = r.randint(0, I + I // 50, ALS_HELD)
    known = (hu < U) & (hi < I)
    truth = (uf_true[np.minimum(hu, U - 1)]
             * if_true[np.minimum(hi, I - 1)]).sum(1) * 1.5 + 3.5
    hr = np.where(known, truth + 0.2 * r.randn(ALS_HELD), 3.5)
    held = MTable({"user": hu.astype(np.int64), "item": hi.astype(np.int64),
                   "rating": hr}, "user LONG, item LONG, rating DOUBLE")
    t0 = time.perf_counter()
    pred = AlsPredictBatchOp(user_col="user", item_col="item",
                             prediction_col="pred").link_from(
        train, MemSourceBatchOp(held)).get_output_table()
    out["predict_s"] = time.perf_counter() - t0
    got = np.asarray(pred.col("pred"), np.float64)
    # the numpy float64 re-rating from the model table
    m = AlsModelDataConverter().load_model(train.get_output_table())
    upos = {int(u): k for k, u in enumerate(m.user_ids)}
    ipos = {int(i): k for k, i in enumerate(m.item_ids)}
    ui = np.asarray([upos.get(int(u), -1) for u in hu])
    ii = np.asarray([ipos.get(int(i), -1) for i in hi])
    valid = (ui >= 0) & (ii >= 0)
    want = np.where(valid, np.einsum(
        "ij,ij->i", m.user_factors[np.maximum(ui, 0)],
        m.item_factors[np.maximum(ii, 0)]), np.nan)
    require(np.array_equal(valid, known) and np.array_equal(
        np.isnan(got), ~valid) and np.array_equal(got[valid], want[valid]),
            "AlsPredictBatchOp equals a numpy float64 re-rating from the "
            "model table, NaN for the unknown ids")
    # EvalRegressionBatchOp over the rows with a prediction
    rated = pred.filter_mask(valid)
    ev = EvalRegressionBatchOp(label_col="rating", prediction_col="pred") \
        .link_from(MemSourceBatchOp(rated))
    rm = ev.collect_metrics()
    y, p = hr[valid], got[valid]
    np_rmse = float(np.sqrt(((p - y) ** 2).mean()))
    require(rm.get("Count") == int(valid.sum())
            and abs(rm.get("RMSE") - np_rmse) <= 1e-12 * np_rmse,
            f"EvalRegressionBatchOp's RMSE equals numpy's ({rm.get('RMSE')}"
            f" against {np_rmse})")
    out.update(held_out=ALS_HELD, unknown=int((~valid).sum()),
               held_out_rmse=rm.get("RMSE"), held_out_mae=rm.get("MAE"),
               held_out_r2=rm.get("R2"), predictions_equal=True)
    # top-K for 1,000 users
    t0 = time.perf_counter()
    topk = AlsTopKPredictBatchOp(user_col="user", prediction_col="recs",
                                 top_k=ALS_TOPK).link_from(
        train, MemSourceBatchOp(MTable(
            {"user": np.arange(ALS_TOPK_USERS, dtype=np.int64)},
            "user LONG"))).get_output_table()
    out["topk_s"] = time.perf_counter() - t0
    scores = m.user_factors[[upos[u] for u in range(ALS_TOPK_USERS)]] \
        @ m.item_factors.T
    for u, rec in enumerate(topk.col("recs")):
        d = json.loads(rec)
        top = np.argsort(-scores[u])[:ALS_TOPK]
        require(d["object"] == [str(m.item_ids[j]) for j in top]
                and d["rate"] == [float(scores[u, j]) for j in top],
                f"user {u}'s top {ALS_TOPK} are numpy's")
    # the stream twin over 4096-row micro-batches
    t0 = time.perf_counter()
    stream = AlsPredictStreamOp(train, user_col="user", item_col="item",
                                prediction_col="pred").link_from(
        MemSourceStreamOp(held, batch_size=ALS_MICRO))
    parts = [np.asarray(mt.col("pred"), np.float64)
             for mt in stream.micro_batches()]
    out["stream_s"] = time.perf_counter() - t0
    sp = np.concatenate(parts)
    require(len(parts) == -(-ALS_HELD // ALS_MICRO)
            and np.array_equal(sp, got, equal_nan=True),
            "AlsPredictStreamOp equals AlsPredictBatchOp")
    out.update(stream_batches=len(parts), stream_rows_per_s=ALS_HELD
               / out["stream_s"], topk_users=ALS_TOPK_USERS)
    # the implicit and nonnegative modes, card vs CPU
    modes = {}
    for mode, tol in (("implicit_prefs", ALS_IMPLICIT_TOL),
                      ("nonnegative", ALS_CARD_CPU_TOL)):
        g = als_run(data, U, I, ALS_MODE_STEPS, dev, **{mode: True})
        c = als_run(data, U, I, ALS_MODE_STEPS, "cpu", **{mode: True})
        fgap = max(float(np.abs(x - y).max() / np.abs(y).max())
                   for x, y in zip(g[:2], c[:2]))
        cgap = float((np.abs(g[2] - c[2]) / c[2]).max())
        require(fgap <= tol and cgap <= ALS_CURVE_RTOL * (
            tol / ALS_CARD_CPU_TOL) and bool(np.isfinite(g[2]).all()),
                f"{mode}: the card within {tol} of the CPU's factors over "
                f"{ALS_MODE_STEPS} supersteps ({fgap}; curve {cgap})")
        if mode == "nonnegative":
            require(bool((g[0] >= 0).all() and (g[1] >= 0).all()),
                    "nonnegative factors on the card")
        modes[mode] = {"factor_max_gap_of_largest": fgap,
                       "curve_max_rel_gap": cgap, "card_s": g[3],
                       "cpu_s": c[3], "curve": g[2].tolist()}
    # the implicit case in float64, card against CPU: rounding, or a fault?
    g = als_run(data, U, I, ALS_MODE_STEPS, dev, dtype=torch.float64,
                implicit_prefs=True)
    c = als_run(data, U, I, ALS_MODE_STEPS, "cpu", dtype=torch.float64,
                implicit_prefs=True)
    fgap = max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(g[:2], c[:2]))
    require(fgap <= ALS_IMPLICIT_F64_TOL,
            f"implicit_prefs in float64: the card within "
            f"{ALS_IMPLICIT_F64_TOL} of the CPU's factors over "
            f"{ALS_MODE_STEPS} supersteps ({fgap})")
    modes["implicit_prefs_f64"] = {
        "factor_max_gap_of_largest": fgap, "card_s": g[3], "cpu_s": c[3],
        "curve": g[2].tolist(),
        "float32_gap_over_float64": modes["implicit_prefs"][
            "factor_max_gap_of_largest"] / max(fgap, 1e-300)}
    out["modes"] = modes
    # dryrun_multichip's ALS leg (__graft_entry__.py:130-137) on the card
    leg = AlsTrainBatchOp(user_col="u", item_col="i", rate_col="r", rank=2,
                          num_iter=2, device=dev).link_from(MemSourceBatchOp(
                              [[u, i, float(2.0 + (u * i) % 3)]
                               for u in range(6) for i in range(5)
                               if (u + i) % 2 == 0], "u INT, i INT, r DOUBLE"))
    lm = AlsModelDataConverter().load_model(leg.get_output_table())
    require(lm.user_factors.shape == (6, 2) and lm.item_factors.shape
            == (5, 2) and bool(np.isfinite(lm.user_factors).all()),
            "dryrun_multichip's ALS leg")
    out["dryrun_leg"] = {"user_factors": lm.user_factors.tolist(),
                         "item_factors": lm.item_factors.tolist()}
    print(f"als (c) [{card}]: AlsTrainBatchOp {out['train_op_s']:.3f} s "
          f"(curve {out['train_rmse']}); {ALS_HELD} held-out pairs "
          f"({out['unknown']} unknown -> NaN) predicted in "
          f"{out['predict_s']:.3f} s, equal to numpy; RMSE "
          f"{out['held_out_rmse']} (= numpy's); top-{ALS_TOPK} of "
          f"{ALS_TOPK_USERS} users in {out['topk_s']:.3f} s; stream "
          f"{len(parts)} micro-batches in {out['stream_s']:.3f} s, equal; "
          f"modes {modes}", flush=True)
    return out


def _rows_equal(a, b) -> bool:
    """Two tables with the same columns and the same cells, row for row."""
    return a.col_names == b.col_names and [
        tuple(repr(v) for v in r) for r in a.to_rows()] == [
        tuple(repr(v) for v in r) for r in b.to_rows()]


def _twin_rows(op, table):
    """A twin over ``table`` in TWIN_MICRO-row micro-batches: (the rows as
    one table, seconds)."""
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    t0 = time.perf_counter()
    parts = list(op.link_from(MemSourceStreamOp(
        table, batch_size=TWIN_MICRO)).micro_batches())
    secs = time.perf_counter() - t0
    out = parts[0]
    for mt in parts[1:]:
        out = out.concat_rows(mt)
    return out, secs


def als_twins(kernels, dev, card):
    """18(d): four stream twins on the card, each row for row its batch
    op's, on phase 9's and 16's models (trained again from their seeds:
    both phases hold two trainings bitwise; their training launches B5,
    P1, the plan and B6), with the multiclass and cluster evaluation.
    The kernels' counts are set to 0 after the trainings and read after
    the twins and their batch ops ran: they launch none."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.classification import (
        GbdtPredictBatchOp, LogisticRegressionPredictBatchOp,
        LogisticRegressionTrainBatchOp, SoftmaxPredictBatchOp,
        SoftmaxTrainBatchOp)
    from alink_tpu_torch.operator.batch.clustering import (
        KMeansModelData, KMeansModelDataConverter, KMeansPredictBatchOp)
    from alink_tpu_torch.operator.batch.evaluation import (
        EvalClusterBatchOp, EvalMultiClassBatchOp)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.stream import (
        GbdtPredictStreamOp, KMeansPredictStreamOp,
        LogisticRegressionPredictStreamOp, SoftmaxPredictStreamOp)
    out = {}
    train = criteo_softmax_rows(7, SPS_ROWS)
    held = criteo_softmax_rows(8, SPS_HELD)
    req = held.select(["features", "label", "bin"])
    src = MemSourceBatchOp(train)
    softmax = SoftmaxTrainBatchOp(vector_col="features", label_col="label",
                                  l2=1e-4, max_iter=SPS_STEPS, epsilon=0.0,
                                  device=dev).link_from(src)
    lr = LogisticRegressionTrainBatchOp(vector_col="features",
                                        label_col="bin",
                                        max_iter=FAMILY_STEPS,
                                        device=dev).link_from(src)
    X, _, adult = adult_data(N_SERVE, seed=1)
    gbdt = gbdt_op(num_trees=GBDT_TREES, device=dev).link_from(
        MemSourceBatchOp(adult_data(ADULT_N)[2]))
    Xk = iris_rows().astype(np.float64)
    gc = kmeans_run(Xk, KM_CHECK_STEPS, dev)[0]
    cols = ["x0", "x1", "x2", "x3"]
    km = KMeansModelDataConverter().save_model(KMeansModelData(
        gc, np.ones(KM_K), "EUCLIDEAN", None, cols))
    kx = Xk[:TWIN_KM_ROWS]
    ktable = MTable({c: kx[:, j] for j, c in enumerate(cols)},
                    ", ".join(f"{c} DOUBLE" for c in cols))
    cls_out = dict(prediction_col="pred", prediction_detail_col="detail")
    cases = (
        ("LogisticRegression", LogisticRegressionPredictBatchOp(**cls_out),
         LogisticRegressionPredictStreamOp(lr, device=dev, **cls_out), lr,
         req),
        ("Softmax", SoftmaxPredictBatchOp(**cls_out),
         SoftmaxPredictStreamOp(softmax, device=dev, **cls_out), softmax,
         req),
        ("Gbdt", GbdtPredictBatchOp(**cls_out),
         GbdtPredictStreamOp(gbdt, device=dev, **cls_out), gbdt, adult),
        ("KMeans", KMeansPredictBatchOp(prediction_col="cid",
                                        prediction_distance_col="dist",
                                        device=dev),
         KMeansPredictStreamOp(MemSourceBatchOp(km), prediction_col="cid",
                               prediction_distance_col="dist",
                               device=dev), MemSourceBatchOp(km), ktable))
    outputs = {}
    _reset(*kernels)
    for name, batch_op, twin, model, table in cases:
        t0 = time.perf_counter()
        want = batch_op.link_from(model, MemSourceBatchOp(table)) \
            .get_output_table()
        batch_s = time.perf_counter() - t0
        got, twin_s = _twin_rows(twin, table)
        require(_rows_equal(got, want),
                f"{name}PredictStreamOp on the card equals its batch op, "
                f"row for row")
        outputs[name] = want
        out[name] = {"rows": table.num_rows, "batch_s": batch_s,
                     "twin_s": twin_s, "twin_rows_per_s": table.num_rows
                     / twin_s, "micro_batch": TWIN_MICRO,
                     "rows_equal": True}
    out["launches"] = _counts(*kernels)
    require(not any(out["launches"].values()),
            f"the twins and their batch ops launched no hand kernel: "
            f"{out['launches']}")
    # EvalMultiClassBatchOp on Softmax's output
    sm = outputs["Softmax"]
    mc = EvalMultiClassBatchOp(label_col="label", prediction_col="pred",
                               prediction_detail_col="detail").link_from(
        MemSourceBatchOp(sm)).collect_metrics()
    acc = float((np.asarray(sm.col("pred")).astype(str)
                 == np.asarray(sm.col("label")).astype(str)).mean())
    require(mc.get("Accuracy") == acc and np.asarray(
        mc.get("ConfusionMatrix")).sum() == sm.num_rows,
            f"EvalMultiClassBatchOp's accuracy is numpy's ({acc})")
    out["Softmax"].update(accuracy=acc, macro_f1=mc.get("MacroF1"),
                          kappa=mc.get("Kappa"),
                          log_loss=mc.to_dict().get("LogLoss"))
    # EvalClusterBatchOp on KMeans' output (its first rows, as vectors)
    ko = outputs["KMeans"]
    n = TWIN_EVAL_ROWS
    ids = np.asarray(ko.col("cid"))[:n]
    vec = np.asarray([" ".join(repr(float(v)) for v in x) for x in kx[:n]],
                     object)
    cm = EvalClusterBatchOp(vector_col="vec", prediction_col="cid").link_from(
        MemSourceBatchOp(MTable({"vec": vec, "cid": ids},
                                "vec STRING, cid LONG"))).collect_metrics()
    xs = kx[:n]
    ssw = float(sum(((xs[ids == c] - xs[ids == c].mean(0)) ** 2).sum()
                    for c in sorted(set(ids.tolist()))))
    require(cm.get("ClusterArray") == np.bincount(ids).tolist()
            and abs(cm.get("SSW") - ssw) <= 1e-9 * ssw,
            f"EvalClusterBatchOp's counts and SSW are numpy's "
            f"({cm.get('SSW')} against {ssw})")
    out["KMeans"].update(eval_rows=n, calinski_harabasz=cm.get(
        "CalinskiHarabasz"), davies_bouldin=cm.get("DaviesBouldin"),
        silhouette=cm.get("SilhouetteCoefficient"), ssw=ssw)
    print(f"twins (d) [{card}]: {out}", flush=True)
    return out


def phase_als(kernels, card, dev=None):
    """18: ALS, the operators and the twins on the card. ``kernels`` are
    the kernel modules; their counts are set to 0 before the phase and
    read after it (ALS launches none of them)."""
    import torch
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is off for the solve's product")
    dev = "cuda" if dev is None else dev
    out = {"card": card}
    t0 = time.perf_counter()
    _reset(*kernels)
    data = als_data(*ALS_SHAPE)
    out["data_s"] = time.perf_counter() - t0
    out["bench_als"] = als_bench(data, dev, card)
    out["operators"] = als_operators(data, dev, card)
    del data
    out["bench_als_large"] = als_bench_large(dev, card)
    out["launches"] = _counts(*kernels)
    require(not any(out["launches"].values()),
            f"ALS and its operators launched no hand kernel: "
            f"{out['launches']}")
    out["twins"] = als_twins(kernels, dev, card)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 19. the serving tier at bench.py's shapes: serve_logreg, serve_hot_swap,
#     serve_chaos
# ---------------------------------------------------------------------------

SERVE_LOGREG = dict(n_rows=2000, dim=64, seed=0, requests=20_000,
                    serial=2_000)                          # bench.py:2501
SERVE_SWAP = dict(n_rows=6144, dim=64, seed=7, per_phase=4_000,
                  micro=256)                               # bench.py:2505
SERVE_CHAOS = dict(n_rows=4096, dim=48, seed=13, per_phase=3_000,
                   micro=128)                              # bench.py:2981
SERVE_PARITY_ROWS = 300
SERVE_SPLIT_ROWS = (1, 8, 32, 128)
FTRL_SWAP_KW = dict(vector_col="vec", label_col="label", alpha=0.1,
                    update_mode="batch", time_interval=1.0)


def serve_fixture(n_rows, dim, seed, dev=None):
    """``bench.py::_serve_fixture`` on the port: seeded dense rows,
    labels from a seeded plane, an LR warm start (4 iterations on the
    first 512 rows, on the card unless ``dev`` says otherwise) and its
    float64 host mapper."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.vector import DenseVector
    from alink_tpu_torch.operator.batch.classification.linear import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.source.sources import \
        MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, dim)
    y = (X @ rng.randn(dim) > 0).astype(np.int64)
    vecs = np.empty(n_rows, object)
    vecs[:] = [DenseVector(X[i]) for i in range(n_rows)]
    tbl = MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", max_iter=4,
        **({"device": dev} if dev else {})).link_from(
        MemSourceBatchOp(tbl.first_n(min(512, n_rows))))
    mapper = LinearModelMapper(
        warm.get_output_table().schema, tbl.select(["vec"]).schema,
        Params({"prediction_col": "pred", "vector_col": "vec"}))
    mapper.load_model(warm.get_output_table())
    return X, tbl, warm, mapper


def serve_predictor(mapper, req, name):
    """A card predictor with every bucket served once (bench.py's warm
    compile; here the first launch of each bucket shape)."""
    from alink_tpu_torch.serving import CompiledPredictor
    pred = CompiledPredictor(mapper, name=name)
    for b in pred.buckets:
        pred.predict_table(req.first_n(min(b, req.num_rows)))
    return pred


def serve_parity(pred, mapper, X, req, name):
    """On 300 rows: the card's scores and labels equal the same
    predictor's on the CPU bit for bit, and its labels equal the float64
    host mapper's outside the float32 rounding band of each row."""
    from alink_tpu_torch.serving import CompiledPredictor
    sub = req.first_n(SERVE_PARITY_ROWS)
    n = sub.num_rows
    cpu = CompiledPredictor(mapper, device="cpu", name=f"{name}_cpu")
    s_gpu, s_cpu = pred.predict_scores(sub), cpu.predict_scores(sub)
    require(s_gpu.dtype == np.float32 and bool(np.isfinite(s_gpu).all()),
            f"{name}: finite float32 scores")
    require(np.array_equal(s_gpu.view(np.int32), s_cpu.view(np.int32)),
            f"{name}: card scores bitwise equal to the CPU predictor's")
    card = [str(v) for v in pred.predict_table(sub).col("pred")]
    require(card == [str(v) for v in cpu.predict_table(sub).col("pred")],
            f"{name}: card labels equal to the CPU predictor's")
    coef = np.asarray(mapper.model.coef)
    terms = np.abs(X[:n]) @ np.abs(coef[1:]) + abs(coef[0])
    s_host = mapper.predict_scores(sub)
    clear = np.abs(s_host) > 64 * 2.0 ** -24 * terms
    host = [str(v) for v in mapper.map_table(sub).col("pred")]
    require(all(a == b for a, b, ok in zip(card, host, clear) if ok),
            f"{name}: labels equal to the float64 host mapper's outside "
            f"the rounding band")
    return {"rows": n, "cpu_bitwise": True,
            "inside_band": int((~clear).sum())}


class B4Clock:
    """CUDA events around every ``serve_dense`` (B4) launch while
    entered: the launching thread records one event before and one after
    the launch on its stream, so the pairs sum the kernel's device time
    over a leg (the events add host time to every dispatch of it)."""

    def __init__(self, ks):
        self.ks = ks
        self.pairs = []
        self._real = None

    def __enter__(self):
        import torch
        real = self._real = self.ks._launch
        pairs = self.pairs

        def timed(name, kind, index, *args):
            if name != "serve_dense":
                return real(name, kind, index, *args)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            real(name, kind, index, *args)
            b.record()
            pairs.append((a, b))
        self.ks._launch = timed
        return self

    def __exit__(self, *exc):
        self.ks._launch = self._real
        return False

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.pairs))


def _leg_stats(stats):
    return {"bucket_hit_rate": stats["bucket_hit_rate"],
            "batch_occupancy": stats["mean_occupancy"],
            "mean_batch_rows": stats["mean_batch_rows"],
            "batches": stats["batches"], "failed": stats["failed"],
            "shed": stats["shed"],
            "fallback_batches": stats["fallback_batches"],
            "loop_respawns": stats["loop_respawns"],
            "programs": stats["programs"],
            "breaker": stats["breaker"]}


def serve_logreg_leg(ks):
    """19(a): bench_serve_logreg — 20,000 requests from 4 clients with
    pipeline 32 against 2,000 serial requests (``max_batch=1``), each
    warmed and timed under ``measured_region``."""
    from alink_tpu_torch.common.profiling2 import measured_region
    from alink_tpu_torch.serving import LoadGenerator, PredictServer
    c = SERVE_LOGREG
    t0 = time.perf_counter()
    X, tbl, _warm, mapper = serve_fixture(c["n_rows"], c["dim"], c["seed"])
    req = tbl.select(["vec"])
    pred = serve_predictor(mapper, req, "serve")
    parity = serve_parity(pred, mapper, X, req, "serve_logreg")
    rows = [req.row(i) for i in range(64)]
    ks.reset_launch_counts()
    serial_srv = PredictServer(pred, max_batch=1, name="serve_serial")
    slg = LoadGenerator(serial_srv.submit, rows, clients=1, pipeline=1)
    slg.run(max(50, c["serial"] // 4))
    with B4Clock(ks) as sclk, measured_region():
        t1 = time.perf_counter()
        srep = slg.run(c["serial"])
        swall = time.perf_counter() - t1
    sstats = serial_srv.stats()
    serial_srv.close()
    srv = PredictServer(pred, name="serve")
    lg = LoadGenerator(srv.submit, rows, clients=4, pipeline=32)
    lg.run(max(100, c["requests"] // 8))
    with B4Clock(ks) as clk, measured_region():
        t1 = time.perf_counter()
        rep = lg.run(c["requests"])
        wall = time.perf_counter() - t1
    stats = srv.stats()
    srv.close()
    launches = ks.launch_counts()
    failed = rep.failures + srep.failures + stats["failed"] + sstats["failed"]
    require(failed == 0, f"serve_logreg: {failed} failed requests")
    for st in (stats, sstats):
        require(st["fallback_batches"] == 0 and st["breaker"]["opens"] == 0,
                f"serve_logreg: no fallback batch and no breaker open "
                f"({st['fallback_batches']}, {st['breaker']})")
    require(launches["serve_dense"] == stats["batches"] + sstats["batches"]
            and launches["serve_dense"] > 0,
            f"serve_logreg: B4 launched once a dispatched batch "
            f"({launches['serve_dense']} launches, "
            f"{stats['batches'] + sstats['batches']} batches)")
    split = {b: dispatch_breakdown(pred, req, reps=30, rows=b)
             for b in SERVE_SPLIT_ROWS}
    b4_ms, sb4_ms = clk.ms(), sclk.ms()
    return {
        "qps": rep.qps, "serial_qps": srep.qps,
        "speedup_vs_serial": rep.qps / max(srep.qps, 1e-9),
        "p50_ms": rep.p50_s * 1e3, "p99_ms": rep.p99_s * 1e3,
        "serial_p50_ms": srep.p50_s * 1e3, "serial_p99_ms": srep.p99_s * 1e3,
        "failed_requests": failed, "parity": parity,
        "b4_ms": b4_ms, "b4_share": b4_ms / (wall * 1e3),
        "serial_b4_ms": sb4_ms, "serial_b4_share": sb4_ms / (swall * 1e3),
        "b4_launches_timed": len(clk.pairs) + len(sclk.pairs),
        "wall_s": wall, "serial_wall_s": swall,
        **_leg_stats(stats), "serial": _leg_stats(sstats),
        "launches": launches, "dispatch_split_ms": split,
        "bound": "serving-host", "dt_s": time.perf_counter() - t0}


def ftrl_swap_stream(tbl, warm, micro, dev=None):
    from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
        FtrlTrainStreamOp
    from alink_tpu_torch.operator.stream.source.sources import \
        MemSourceStreamOp
    return FtrlTrainStreamOp(warm, device=dev, **FTRL_SWAP_KW).link_from(
        MemSourceStreamOp(tbl, batch_size=micro))


def tensors_bitwise(a, b):
    """Two tuples of CPU tensors equal in dtype, shape and bytes."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape)
        and x.numpy().tobytes() == y.numpy().tobytes() for x, y in zip(a, b))


def serve_hot_swap_leg(ks, feeder_kind, fixture, tables):
    """19(b): bench_serve_hot_swap — 4,000 requests of one probe row a
    phase before, during (2x) and after the swaps of an FTRL stream on
    256-row micro-batches, through ``ModelStreamFeeder`` or
    ``DeviceWeightsFeeder``; every response checked against the set of
    the versions' CPU-predictor answers. The model leg runs first and
    puts the model tables it swapped in into ``tables``; the device leg
    runs the same stream and requires the weights it installed on the
    card to equal those tables' bitwise, swap by swap, so both legs'
    expected sets come from the host tables, never from the card's own
    arrays."""
    from alink_tpu_torch.common.profiling2 import measured_region
    from alink_tpu_torch.serving import (CompiledPredictor,
                                         DeviceWeightsFeeder, LoadGenerator,
                                         ModelStreamFeeder, PredictServer)
    c = SERVE_SWAP
    t0 = time.perf_counter()
    X, tbl, warm, mapper, cpu_swaps = fixture
    req = tbl.select(["vec"])
    name = f"serve_swap_{feeder_kind}"
    pred = serve_predictor(mapper, req, name)
    parity = serve_parity(pred, mapper, X, req, name)
    probe = req.row(0)
    cpu = CompiledPredictor(mapper, device="cpu", name=f"{name}_cpu")
    srv = PredictServer(pred, name=name)
    lg = LoadGenerator(srv.submit, [probe], clients=4, pipeline=8,
                       collect_responses=True)
    lg.run(max(100, c["per_phase"] // 4))
    ks.reset_launch_counts()
    batches0 = srv.stats()["batches"]

    installed = []

    def device_swap(_version):
        # the weights just installed on the card, copied to the host for
        # the check (the feeder itself makes no host copy)
        installed.append(tuple(a.cpu() for a in pred.model_arrays))
    ftrl = ftrl_swap_stream(tbl, warm, c["micro"])
    with B4Clock(ks) as clk, measured_region():
        t1 = time.perf_counter()
        rep_before = lg.run(c["per_phase"])
        feeder = (ModelStreamFeeder(srv, ftrl) if feeder_kind == "model"
                  else DeviceWeightsFeeder(srv, ftrl, on_swap=device_swap))
        feeder.start()
        rep_during = lg.run(2 * c["per_phase"])
        swaps = feeder.join(timeout=300)
        rep_after = lg.run(c["per_phase"])
        wall = time.perf_counter() - t1
    stats = srv.stats()
    srv.close()
    launches = ks.launch_counts()
    if feeder_kind == "model":
        tables[:] = [mt for _v, mt in feeder.versions]
    expected = {repr(tuple(cpu.predict_row(probe)))}
    unequal = 0
    for k, mt in enumerate(tables):
        cpu.swap_model(mt)
        expected.add(repr(tuple(cpu.predict_row(probe))))
        if feeder_kind == "device" and k < len(installed):
            unequal += not tensors_bitwise(installed[k], cpu.model_arrays)
    if feeder_kind == "device":
        require(len(installed) == len(tables) == swaps and unequal == 0,
                f"{name}: the weights installed on the card equal the "
                f"model leg's tables bitwise ({len(installed)} installed, "
                f"{len(tables)} tables, {unequal} unequal)")
    observed = {repr(tuple(r)) for rep in (rep_before, rep_during, rep_after)
                for r in rep.responses}
    torn = len(observed - expected)
    failed = (rep_before.failures + rep_during.failures + rep_after.failures
              + stats["failed"])
    require(torn == 0, f"{name}: {torn} torn responses")
    require(failed == 0, f"{name}: {failed} failed requests")
    require(swaps == cpu_swaps and feeder.skipped == 0,
            f"{name}: {swaps} swaps, the CPU run emits {cpu_swaps}")
    require(stats["fallback_batches"] == 0
            and stats["breaker"]["opens"] == 0,
            f"{name}: no fallback batch and no breaker open")
    dispatched = stats["batches"] - batches0
    require(launches["serve_dense"] == dispatched > 0,
            f"{name}: B4 launched once a dispatched batch "
            f"({launches['serve_dense']} launches, {dispatched} batches)")
    b4_ms = clk.ms()
    return {
        "feeder": feeder_kind, "qps": rep_during.qps,
        "model_swaps": swaps, "cpu_model_swaps": cpu_swaps,
        "failed_requests": failed, "torn_responses": torn,
        "distinct_responses": len(observed), "versions": len(expected),
        "p99_ms_before": rep_before.p99_s * 1e3,
        "p99_ms_during": rep_during.p99_s * 1e3,
        "p99_ms_after": rep_after.p99_s * 1e3,
        "p50_ms_during": rep_during.p50_s * 1e3,
        "qps_before": rep_before.qps, "qps_after": rep_after.qps,
        "b4_ms": b4_ms, "b4_share": b4_ms / (wall * 1e3), "wall_s": wall,
        "weights_checked": len(installed), "parity": parity,
        **_leg_stats(stats), "launches": launches,
        "bound": "serving-host", "dt_s": time.perf_counter() - t0}


def serve_chaos_leg(ks):
    """19(c): bench_serve_chaos — 3,000 requests a phase; the storm
    ``serve.dispatch:1-14:error;feeder.snapshot:1-1:corrupt`` under an
    FTRL swap stream, probes until the breaker closes, then
    ``serve.dispatch:1:delay:30`` with 6 requests of a 4 ms deadline
    queued behind it, then a recovery phase with the faults cleared.
    ``ALINK_TPU_SERVE_BREAKER_MAX_MS=200``."""
    from alink_tpu_torch.common.faults import (FAULT_ENV, reset_faults,
                                               scoped_fault_env)
    from alink_tpu_torch.common.profiling2 import measured_region
    from alink_tpu_torch.serving import (CompiledPredictor, LoadGenerator,
                                         ModelStreamFeeder, PredictServer)
    c = SERVE_CHAOS
    t0 = time.perf_counter()
    X, tbl, warm, mapper = serve_fixture(c["n_rows"], c["dim"], c["seed"])
    req = tbl.select(["vec"])
    cpu_snapshots = sum(1 for _ in ftrl_swap_stream(
        tbl, warm, c["micro"], dev="cpu").timed_batches())
    pred = serve_predictor(mapper, req, "serve_chaos")
    parity = serve_parity(pred, mapper, X, req, "serve_chaos")
    probe = req.row(0)
    require(FAULT_ENV not in os.environ, "no fault armed before the storm")
    os.environ["ALINK_TPU_SERVE_BREAKER_MAX_MS"] = "200"
    srv = PredictServer(pred, name="serve_chaos")
    tally = {"submitted": 0, "results": 0, "typed": 0, "silent": 0}
    responses = []

    def lg(requests):
        rep = LoadGenerator(srv.submit, [probe], clients=4, pipeline=8,
                            collect_responses=True).run(requests)
        tally["submitted"] += rep.requests
        tally["results"] += rep.requests - rep.failures
        tally["typed"] += rep.failures - rep.timeouts
        tally["silent"] += rep.timeouts
        responses.extend(rep.responses)
        return rep

    def settle(futs):
        for f in futs:
            try:
                responses.append(tuple(f.result(60)))
                tally["results"] += 1
            except TimeoutError:
                tally["silent"] += 1
            except Exception:
                tally["typed"] += 1

    lg(max(100, c["per_phase"] // 4))
    ks.reset_launch_counts()
    with B4Clock(ks) as clk, measured_region():
        rep_before = lg(c["per_phase"])
        clean = srv.stats()
        launches_before = ks.launch_counts()["serve_dense"]
        reset_faults()
        with scoped_fault_env("serve.dispatch:1-14:error;"
                              "feeder.snapshot:1-1:corrupt"):
            feeder = ModelStreamFeeder(
                srv, ftrl_swap_stream(tbl, warm, c["micro"])).start()
            rep_storm = lg(c["per_phase"])
            wait_until = time.monotonic() + 20
            while srv.breaker_stats()["state"] != "closed" \
                    and time.monotonic() < wait_until:
                tally["submitted"] += 1
                settle([srv.submit(probe)])
                time.sleep(0.05)
            # the same visit counters: the corrupt window stays
            # exactly-once (the scope restores the variable on exit)
            os.environ[FAULT_ENV] = ("serve.dispatch:1:delay:30;"
                                     "feeder.snapshot:1-1:corrupt")
            first = srv.submit(probe)
            time.sleep(0.01)
            shed = [srv.submit(probe, deadline_s=0.004) for _ in range(6)]
            tally["submitted"] += 7
            settle([first] + shed)
            swaps = feeder.join(timeout=180)
        reset_faults()
        time.sleep(0.25)
        pre = srv.stats()
        launches_pre = ks.launch_counts()["serve_dense"]
        rep_after = lg(c["per_phase"])
        stats = srv.stats()
    srv.close()
    del os.environ["ALINK_TPU_SERVE_BREAKER_MAX_MS"]
    launches = ks.launch_counts()
    compiled_after = (stats["batches"] - pre["batches"]) \
        - (stats["fallback_batches"] - pre["fallback_batches"])
    expected = set()
    cpu = CompiledPredictor(mapper, device="cpu", name="serve_chaos_cpu")
    expected.add(repr(tuple(cpu.predict_row(probe))))
    for _v, mt in feeder.versions:
        cpu.swap_model(mt)
        expected.add(repr(tuple(cpu.predict_row(probe))))
    torn = len({repr(tuple(r)) for r in responses} - expected)
    brk = stats["breaker"]
    require(tally["silent"] == 0, f"serve_chaos: {tally['silent']} silent "
            f"drops")
    require(tally["results"] + tally["typed"] == tally["submitted"],
            f"serve_chaos: every request answered or rejected {tally}")
    require(tally["typed"] > 0, "serve_chaos: typed rejections in the storm")
    require(torn == 0, f"serve_chaos: {torn} torn responses")
    require(brk["opens"] >= 1 and brk["state"] == "closed",
            f"serve_chaos: the breaker opened and ends closed ({brk})")
    require(compiled_after > 0, "serve_chaos: device batches after the storm")
    require(clean["fallback_batches"] == 0
            and clean["breaker"]["opens"] == 0
            and stats["fallback_batches"] == pre["fallback_batches"]
            and brk["opens"] == pre["breaker"]["opens"],
            "serve_chaos: no fallback batch and no breaker open in the "
            "clean phases")
    require(feeder.skipped == 1 and swaps == cpu_snapshots - 1,
            f"serve_chaos: {swaps} swaps and {feeder.skipped} skipped; the "
            f"CPU run emits {cpu_snapshots}")
    require(launches_before > 0
            and launches["serve_dense"] - launches_pre >= compiled_after,
            f"serve_chaos: B4 launched before and after the storm "
            f"({launches_before}, {launches['serve_dense'] - launches_pre} "
            f"for {compiled_after} device batches)")
    b4_ms = clk.ms()
    return {
        "qps": rep_storm.qps, "qps_before": rep_before.qps,
        "qps_after": rep_after.qps,
        "p99_ms_before": rep_before.p99_s * 1e3,
        "p99_ms_during": rep_storm.p99_s * 1e3,
        "p99_ms_after": rep_after.p99_s * 1e3,
        "p50_ms_during": rep_storm.p50_s * 1e3,
        "requests_total": tally["submitted"],
        "typed_rejections": tally["typed"], "silent_drops": tally["silent"],
        "torn_responses": torn, "shed_requests": stats["shed"],
        "breaker_opens": brk["opens"], "breaker_reopens": brk["reopens"],
        "breaker_probes": brk["probes"],
        "fallback_batches": stats["fallback_batches"],
        "loop_respawns": stats["loop_respawns"],
        "feeder_retries": feeder.retried, "feeder_skipped": feeder.skipped,
        "model_swaps": swaps, "cpu_snapshots": cpu_snapshots,
        "post_storm_compiled_batches": compiled_after,
        "b4_ms": b4_ms, "launches": launches, "parity": parity,
        "bound": "serving-host", "dt_s": time.perf_counter() - t0}


def phase_serving(kernels, card):
    """19: the serving tier at bench.py's serving shapes. ``kernels``
    are the kernel modules (``serve`` first); their counts are set to 0
    before the phase and read after it."""
    ks = kernels[0]
    out = {"card": card}
    t0 = time.perf_counter()
    _reset(*kernels)
    out["serve_logreg"] = serve_logreg_leg(ks)
    c = SERVE_SWAP
    X, tbl, warm, mapper = serve_fixture(c["n_rows"], c["dim"], c["seed"])
    cpu_swaps = sum(1 for _ in ftrl_swap_stream(
        tbl, warm, c["micro"], dev="cpu").timed_batches())
    fixture = (X, tbl, warm, mapper, cpu_swaps)
    tables = []
    out["serve_hot_swap"] = serve_hot_swap_leg(ks, "model", fixture, tables)
    out["serve_hot_swap_device"] = serve_hot_swap_leg(ks, "device", fixture,
                                                      tables)
    out["serve_chaos"] = serve_chaos_leg(ks)
    # each leg reads B4's and B5's counts from its own reset; the other
    # modules' counts run over the whole phase
    legs = ("serve_logreg", "serve_hot_swap", "serve_hot_swap_device",
            "serve_chaos")
    out["launches"] = {k: sum(out[leg]["launches"][k] for leg in legs)
                       for k in ks.launch_counts()}
    others = _counts(*kernels[1:])
    require(not any(others.values()),
            f"the serving legs launch no other kernel: {others}")
    out["launches"].update(others)
    out["seconds"] = time.perf_counter() - t0
    return out


def print_serving(rec):
    a, ch = rec["serve_logreg"], rec["serve_chaos"]
    print(f"19(a) serve_logreg: {a['qps']:.1f} qps, serial "
          f"{a['serial_qps']:.1f} qps, speedup {a['speedup_vs_serial']:.2f}, "
          f"p50 {a['p50_ms']:.4f} ms, p99 {a['p99_ms']:.4f} ms (serial "
          f"{a['serial_p50_ms']:.4f} / {a['serial_p99_ms']:.4f}), "
          f"occupancy {a['batch_occupancy']:.4f}, mean batch "
          f"{a['mean_batch_rows']:.2f} rows, bucket hit rate "
          f"{a['bucket_hit_rate']:.4f}, B4 {a['b4_ms']:.3f} ms = "
          f"{a['b4_share']:.5f} of {a['wall_s']:.3f} s (serial "
          f"{a['serial_b4_share']:.5f}), launches {a['launches']}",
          flush=True)
    for b, split in a["dispatch_split_ms"].items():
        print(f"19(a) one {b}-row dispatch, median ms per stage: {split}")
    for leg in ("serve_hot_swap", "serve_hot_swap_device"):
        h = rec[leg]
        print(f"19(b) {leg}: {h['qps']:.1f} qps during, swaps "
              f"{h['model_swaps']} (CPU {h['cpu_model_swaps']}), torn "
              f"{h['torn_responses']}, failed {h['failed_requests']}, "
              f"installed weights checked {h['weights_checked']}, p99 "
              f"before / during / after {h['p99_ms_before']:.4f} / "
              f"{h['p99_ms_during']:.4f} / {h['p99_ms_after']:.4f} ms, "
              f"occupancy {h['batch_occupancy']:.4f}, bucket hit rate "
              f"{h['bucket_hit_rate']:.4f}, shed {h['shed']}, B4 share "
              f"{h['b4_share']:.5f}, {h['dt_s']:.1f} s", flush=True)
    print(f"19(c) serve_chaos: {ch['qps']:.1f} qps in the storm, "
          f"{ch['requests_total']} requests, typed {ch['typed_rejections']}, "
          f"silent {ch['silent_drops']}, torn {ch['torn_responses']}, shed "
          f"{ch['shed_requests']}, breaker opens / reopens / probes "
          f"{ch['breaker_opens']} / {ch['breaker_reopens']} / "
          f"{ch['breaker_probes']}, fallback {ch['fallback_batches']}, "
          f"swaps {ch['model_swaps']} (skipped {ch['feeder_skipped']}), "
          f"post-storm device batches {ch['post_storm_compiled_batches']}, "
          f"p99 before / during / after {ch['p99_ms_before']:.4f} / "
          f"{ch['p99_ms_during']:.4f} / {ch['p99_ms_after']:.4f} ms, "
          f"{ch['dt_s']:.1f} s", flush=True)
    print(f"phase 19: {rec['seconds']:.1f} s, launches {rec['launches']}",
          flush=True)


E2E = dict(n_rows=4096, dim=32, seed=17, storm_rows=2048,
           batch_rows=128)                                  # bench.py:3145
E2E_TRAIN_STORM = ("ftrl.batch:4-4;ckpt.save:2-2:error;ingest.batch:3-3;"
                   "prefetch.get:1-60:delay:1")             # bench.py:3077
E2E_SERVE_STORM = "serve.dispatch:1-8:error;feeder.snapshot:1-1:corrupt"
# the card's golden run against the CPU's, both float32: each window's
# AUC within this, and a label may differ only where the CPU's
# probability is this close to 0.5 (the float32 rounding band of a
# margin near 0 after a few hundred float32 FTRL updates)
E2E_AUC_TOL = 1e-4
E2E_LABEL_BAND = 1e-4
# ... and each scored probability within this of the CPU's: B4 meets its
# plain version at the DAG's shapes (d = 32, 128-row buckets) only here,
# and the AUC and the labels above hold under any monotone, sign-keeping
# error (a doubled margin); float32 rounding reads 1.35e-5 on an H100
E2E_P_TOL = 1e-4


def e2e_eval_files(art):
    return tuple(Path(art, "eval", f).read_text()
                 for f in ("windows.jsonl", "scores.jsonl"))


def e2e_scores(art):
    return [json.loads(ln) for ln in
            Path(art, "eval", "scores.jsonl").read_text().splitlines()]


def e2e_run(ks, dag):
    """One DAG run: its report, B4's launches during it and its seconds."""
    b4 = ks.launch_counts()["serve_dense"]
    t0 = time.perf_counter()
    rep = dag.run()
    return rep, ks.launch_counts()["serve_dense"] - b4, \
        time.perf_counter() - t0


def e2e_compiled_batches(rep):
    """A floor of the dispatched batches that the kernel served: all but
    the breaker's host fallbacks and the batches that failed (each failed
    batch failed at least one request, so the failed requests bound
    them)."""
    st = rep.server_stats
    return max(0, st["batches"] - st["fallback_batches"] - st["failed"])


def phase_online(kernels, card, dev=None, sizes=None):
    """20: ``bench.py::bench_serve_online_e2e`` on the port — the whole
    FTRLExample loop as one supervised ``OnlineDag`` on the card (dense
    rows of ``_serve_fixture(4096, 32, seed=17)``, 128-row micro-batches,
    a checkpoint every 2, ``ALINK_TPU_SERVE_BREAKER_MAX_MS=200``): (a)
    steady state, throughput pacing, ``time_interval=3.0``, under
    ``SloContract(2.0, 30.0, 0.75)``; (b) the deterministic golden run on
    the first 2,048 rows, ``time_interval=2.0``, twice; (c) the trainer
    storm with bench.py's ``clear_trainer_kill``; (d) the serve storm;
    then (b) on the CPU (float32) against the card's. ``kernels`` are the
    kernel modules (``serve`` first); their counts are set to 0 just
    before the runs and read just after them."""
    import gc
    import shutil
    import tempfile
    from alink_tpu_torch.common.faults import FAULT_ENV, scoped_fault_env
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.online import (RESTART_POLICIES, OnlineDag,
                                        SloContract, load_model_table)
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    from alink_tpu_torch.serving import CompiledPredictor
    c = dict(E2E, **(sizes or {}))
    ks = kernels[0]
    t_phase = time.perf_counter()
    X, tbl, warm, _mapper = serve_fixture(c["n_rows"], c["dim"], c["seed"],
                                          dev=dev)
    storm_tbl = tbl.first_n(c["storm_rows"])
    dirs = []

    def art(prefix):
        dirs.append(tempfile.mkdtemp(prefix=f"e2e_{prefix}_{os.getpid()}_"))
        return dirs[-1]

    def mkdag(source_tbl, path, interval, device=dev, **kw):
        return OnlineDag(
            source_fn=lambda: MemSourceStreamOp(
                source_tbl, batch_size=c["batch_rows"]),
            warm_model=warm, artifacts_dir=path, label_col="label",
            vector_col="vec", time_interval=interval, checkpoint_every=2,
            name="serve_online_e2e", device=device, **kw)

    def clear_trainer_kill(stage, exc):
        # the kill is keyed on the batch NUMBER, which the checkpoint
        # replay revisits: the supervisor's callback clears that entry
        if getattr(exc, "site", None) == "ftrl.batch":
            os.environ[FAULT_ENV] = ";".join(
                e for e in os.environ.get(FAULT_ENV, "").split(";")
                if e and not e.startswith("ftrl.batch"))

    require(FAULT_ENV not in os.environ, "no fault armed before phase 20")
    os.environ["ALINK_TPU_SERVE_BREAKER_MAX_MS"] = "200"
    runs = {}
    try:
        _reset(*kernels)
        slo = SloContract(serve_p99_s=2.0, swap_staleness_s=30.0,
                          final_window_auc=0.75, name="serve_online_e2e")
        with scoped_fault_env(None):
            gen2 = gc.get_stats()[2]["collections"]
            runs["a"] = e2e_run(ks, mkdag(tbl, art("steady"), 3.0,
                                          pacing="throughput", slo=slo))
            gen2 = gc.get_stats()[2]["collections"] - gen2
            g_art = art("gold")
            golden = mkdag(storm_tbl, g_art, 2.0)
            runs["b"] = e2e_run(ks, golden)
            g2_art = art("gold2")
            runs["b2"] = e2e_run(ks, mkdag(storm_tbl, g2_art, 2.0))
        s3_art = art("storm_train")
        with scoped_fault_env(E2E_TRAIN_STORM):
            runs["c"] = e2e_run(ks, mkdag(storm_tbl, s3_art, 2.0,
                                          on_stage_event=clear_trainer_kill))
        s4_art = art("storm_serve")
        with scoped_fault_env(E2E_SERVE_STORM):
            runs["d"] = e2e_run(ks, mkdag(storm_tbl, s4_art, 2.0))
        launches = _counts(*kernels)
        # (b) on the CPU, float32 as on the card, from the same warm start
        c_art = art("gold_cpu")
        with scoped_fault_env(None):
            cpu_rep = mkdag(storm_tbl, c_art, 2.0, device="cpu").run()
        # the last swap's artifact answers as the model the server served
        last = load_model_table(os.path.join(g_art, "serving",
                                             "last_good.json"))
        require(last is not None, "20(b): last_good.json loads")
        req = storm_tbl.select(["vec"]).first_n(512)
        m = LinearModelMapper(last[1].schema, req.schema,
                              Params({"prediction_col": "pred",
                                      "prediction_detail_col": "detail",
                                      "vector_col": "vec"}))
        m.load_model(last[1])
        reloaded = CompiledPredictor(m, device=dev, name="e2e_last_good")
        served = golden.predictor
        require(last[0] == served.model_version
                and golden._versions[-1][0] == last[0],
                f"20(b): last_good.json holds the last swapped version "
                f"({last[0]}, served {served.model_version})")
        got = reloaded.predict_table(req).to_rows()
        want = served.predict_table(req).to_rows()
        require([repr(tuple(r)) for r in got] == [repr(tuple(r))
                                                  for r in want],
                "20(b): the reloaded last good model answers as the served "
                "model, bit for bit")
        files = {k: e2e_eval_files(d) for k, d in (
            ("b", g_art), ("b2", g2_art), ("c", s3_art), ("d", s4_art))}
        c_scores, g_scores = e2e_scores(c_art), e2e_scores(g_art)
    finally:
        del os.environ["ALINK_TPU_SERVE_BREAKER_MAX_MS"]
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    reps = {k: v[0] for k, v in runs.items()}
    a, b, r3, r4 = reps["a"], reps["b"], reps["c"], reps["d"]
    for k, rep in reps.items():
        require(rep.failed is None, f"20({k}) failed: {rep.failed}")
    require(a.slo_ok() and a.final_window_auc is not None
            and a.final_window_auc >= 0.75,
            f"20(a): the SLO contract holds and the final-window AUC "
            f"{a.final_window_auc} >= 0.75 ({[v.to_dict() for v in a.slo]})")
    require(files["b2"] == files["b"],
            "20(b): a second golden run's journals are byte-identical")
    require(files["c"] == files["b"],
            "20(c): the trainer storm's journals are the golden run's, "
            "byte for byte")
    require(r3.restarts and all(
        r["policy"] == (RESTART_POLICIES["ingest"] if r["stage"] == "ingest"
                        else RESTART_POLICIES["train"])
        and r["recovery_s"] is not None for r in r3.restarts),
        f"20(c): every restart typed by its policy with a measured "
        f"recovery: {r3.restarts}")
    require({r.get("site") for r in r3.restarts}
            == {"ftrl.batch", "ckpt.save", "ingest.batch"},
            f"20(c): the storm's three faults restarted their stages: "
            f"{r3.restarts}")
    brk = r4.server_stats["breaker"]
    require(brk["opens"] >= 1 and brk["state"] == "closed",
            f"20(d): the breaker opened and ends closed ({brk})")
    require(files["d"][1].splitlines()[-1] == files["b"][1].splitlines()[-1],
            "20(d): the last scored batch is the golden run's, bitwise")
    require(r4.feeder_skipped >= 1 and r4.typed_rejections > 0,
            f"20(d): the corrupt snapshot skipped ({r4.feeder_skipped}) and "
            f"typed rejections ({r4.typed_rejections})")
    require(sum(r.silent_drops for r in reps.values()) == 0,
            "20: no silent drop in any run")
    for k in ("a", "b", "b2", "c"):
        st = reps[k].server_stats
        require(st["fallback_batches"] == 0 and st["breaker"]["opens"] == 0
                and st["failed"] == 0,
                f"20({k}): no fallback batch, breaker open or failed "
                f"request ({st['fallback_batches']}, {st['breaker']}, "
                f"{st['failed']})")
    for k, (rep, b4, _) in runs.items():
        require(b4 >= e2e_compiled_batches(rep) and b4 > 0,
                f"20({k}): B4 launched for every batch the card served "
                f"({b4} launches, {e2e_compiled_batches(rep)} batches)")
    others = {k: v for k, v in launches.items() if k != "serve_dense"}
    require(not any(others.values()),
            f"the DAG launches no other kernel: {others}")
    # (b) on the card against the same run on the CPU
    require(len(cpu_rep.windows) == len(b.windows)
            and cpu_rep.scored_rows == b.scored_rows
            and cpu_rep.swaps == b.swaps
            and [w["n"] for w in cpu_rep.windows]
            == [w["n"] for w in b.windows],
            f"20(b): the CPU run's windows, rows and swaps are the card's "
            f"({len(cpu_rep.windows)}, {cpu_rep.scored_rows}, "
            f"{cpu_rep.swaps})")
    auc_gap = max(abs(w["auc"] - v["auc"])
                  for w, v in zip(b.windows, cpu_rep.windows))
    pg = np.concatenate([s["p"] for s in g_scores])
    pc = np.concatenate([s["p"] for s in c_scores])
    outside = np.abs(pc - 0.5) > E2E_LABEL_BAND
    p_gap = float(np.abs(pg - pc).max())
    require(auc_gap <= E2E_AUC_TOL,
            f"20(b): each window's AUC within {E2E_AUC_TOL} of the CPU's "
            f"({auc_gap})")
    require(p_gap <= E2E_P_TOL,
            f"20(b): each scored probability within {E2E_P_TOL} of the "
            f"CPU's ({p_gap})")
    require(np.array_equal((pg > 0.5)[outside], (pc > 0.5)[outside])
            and [s["y"] for s in g_scores] == [s["y"] for s in c_scores],
            "20(b): the card's labels are the CPU's outside the rounding "
            "band")
    recovery = {}
    for rec in r3.restarts:
        recovery[rec.get("site") or rec.get("error")] = rec["recovery_s"]
    out = {
        "qps": a.qps, "p99_ms": a.p99_s * 1e3,
        "p50_ms": a.server_stats["p50_s"] * 1e3, "gen2_collections": gen2,
        "swap_staleness_max_ms": a.swap_staleness_max_s * 1e3,
        "swap_staleness_mean_ms": a.swap_staleness_mean_s * 1e3,
        "model_swaps": a.swaps, "windows": len(a.windows),
        "window_auc": [w["auc"] for w in a.windows],
        "final_window_auc": a.final_window_auc,
        "slo": [v.to_dict() for v in a.slo], "slo_breaches": len(a.breaches),
        "scored_rows": a.scored_rows, "shed_requests": a.shed_requests,
        "silent_drops": sum(r.silent_drops for r in reps.values()),
        "typed_rejections": r4.typed_rejections,
        "storm_restarts": len(r3.restarts), "storm_bitwise_journals": True,
        "recovery_s_by_fault": recovery,
        "breaker_opens": brk["opens"],
        "fallback_batches": r4.server_stats["fallback_batches"],
        "feeder_skipped": r4.feeder_skipped,
        "golden": {"windows": len(b.windows), "swaps": b.swaps,
                   "window_auc": [w["auc"] for w in b.windows],
                   "card_vs_cpu_auc_max_gap": auc_gap,
                   "card_vs_cpu_p_max_gap": p_gap,
                   "rows_in_band": int((~outside).sum())},
        "run_s": {k: v[2] for k, v in runs.items()},
        "b4_launches": {k: v[1] for k, v in runs.items()},
        "compiled_batches": {k: e2e_compiled_batches(v[0])
                             for k, v in runs.items()},
        "launches": launches, "bound": "serving-host",
        "seconds": time.perf_counter() - t_phase}
    return out


def print_online(rec):
    print(f"20(a) serve_online_e2e: {rec['qps']:.1f} qps, p50 "
          f"{rec['p50_ms']:.4f} ms, p99 {rec['p99_ms']:.4f} ms, swap "
          f"staleness max / mean "
          f"{rec['swap_staleness_max_ms']:.4f} / "
          f"{rec['swap_staleness_mean_ms']:.4f} ms, swaps "
          f"{rec['model_swaps']}, windows {rec['windows']} AUC "
          f"{[round(v, 6) for v in rec['window_auc']]}, final "
          f"{rec['final_window_auc']}, SLO "
          f"{[(v['slo'], v['ok'], v['observed']) for v in rec['slo']]}, "
          f"scored rows {rec['scored_rows']}, shed {rec['shed_requests']}, "
          f"gen-2 collections {rec['gen2_collections']}", flush=True)
    g = rec["golden"]
    print(f"20(b) golden: windows {g['windows']}, swaps {g['swaps']}, AUC "
          f"{[round(v, 6) for v in g['window_auc']]}; card vs CPU: AUC max "
          f"gap {g['card_vs_cpu_auc_max_gap']}, probability max gap "
          f"{g['card_vs_cpu_p_max_gap']}, rows in the band "
          f"{g['rows_in_band']}; a second run byte-identical", flush=True)
    print(f"20(c) trainer storm: {rec['storm_restarts']} restarts, recovery "
          f"s by fault {rec['recovery_s_by_fault']}, journals bitwise "
          f"{rec['storm_bitwise_journals']}", flush=True)
    print(f"20(d) serve storm: breaker opens {rec['breaker_opens']}, "
          f"fallback batches {rec['fallback_batches']}, feeder skipped "
          f"{rec['feeder_skipped']}, typed rejections "
          f"{rec['typed_rejections']}; silent drops {rec['silent_drops']}",
          flush=True)
    print(f"phase 20: B4 launches by run {rec['b4_launches']} for compiled "
          f"batches {rec['compiled_batches']}, run s "
          f"{ {k: round(v, 3) for k, v in rec['run_s'].items()} }, "
          f"{rec['seconds']:.1f} s", flush=True)


class _ExecSpy:
    """Keep the result of every ``IterativeComQueue.exec`` while active."""

    def __enter__(self):
        from alink_tpu_torch.engine import IterativeComQueue
        self.cls, self.orig, self.results = IterativeComQueue, \
            IterativeComQueue.exec, []
        spy = self

        def exec_(q):
            r = spy.orig(q)
            spy.results.append(r)
            return r
        IterativeComQueue.exec = exec_
        return self

    def __exit__(self, *exc):
        self.cls.exec = self.orig


def health_series_equal(mon, result):
    """The monitor's series are the probes the result carries."""
    probes = result.probes()
    return sorted(probes) == mon.series_names() and all(
        np.array_equal(mon.series(k)[1], np.asarray(v, np.float64))
        and list(mon.series(k)[0]) == list(range(1, len(v) + 1))
        for k, v in probes.items())


def phase_health(kernels, card):
    """20(e): training health on the card. L-BFGS at phase 12(b)'s shape,
    KMeans at 16(d)'s and the FTRL batch drain at phase 14's (padded-COO,
    6 x 4096 rows over 65,537) with a ``HealthMonitor`` give the bits of
    the same runs without one, and the monitors' series are the probes
    the results carry (FTRL: its progressive log loss); the sparse batch
    step and the monitor's per-micro-batch scalars run under sync debug
    "error"; a NaN label raises ``HealthAlertError``
    (``raise_on=("critical",)``) at the first checkpoint boundary with
    that snapshot on disk, and the snapshot resumes."""
    import tempfile
    import torch
    from alink_tpu_torch.common.health import HealthAlertError, HealthMonitor
    from alink_tpu_torch.engine import recovery
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    t0 = time.perf_counter()
    out = {}
    _reset(*kernels)
    # L-BFGS, bench_logreg's field-blocked shape
    fb, y = fb_criteo(0)
    data = {"fb_idx": fb, "y": y, "w": np.ones(LR_ROWS, np.float32)}
    bare = lbfgs_run(data, LR_CHECK_STEPS)
    mon = HealthMonitor(source="qn")
    with _ExecSpy() as spy:
        withm = lbfgs_run(data, LR_CHECK_STEPS, health=mon)
    require(np_bits_equal(bare[0], withm[0])
            and np_bits_equal(bare[1], withm[1]) and bare[2] == withm[2],
            "20(e): L-BFGS with a monitor is bitwise the run without")
    require(health_series_equal(mon, spy.results[-1]),
            f"20(e): the L-BFGS monitor's series are the result's probes "
            f"({mon.series_names()})")
    out["lbfgs"] = {"supersteps": int(withm[2]), "alerts": [
        a.to_dict() for a in mon.alerts], "s": withm[3], "bare_s": bare[3]}
    # KMeans, bench_kmeans' shape
    X = iris_rows()
    kb = kmeans_run(X, KM_CHECK_STEPS, "cuda")
    mon = HealthMonitor(source="kmeans")
    with _ExecSpy() as spy:
        kw = kmeans_run(X, KM_CHECK_STEPS, "cuda", health=mon)
    require(np_bits_equal(kb[0], kw[0]) and np_bits_equal(kb[1], kw[1]),
            "20(e): KMeans with a monitor is bitwise the run without")
    require(health_series_equal(mon, spy.results[-1]),
            "20(e): the KMeans monitor's series are the result's probes")
    out["kmeans"] = {"supersteps": int(kw[2]), "alerts": [
        a.to_dict() for a in mon.alerts]}
    # the FTRL batch drain, phase 14's padded-COO main path
    rng = np.random.default_rng(1417)
    micro = 6
    rows = batch_rows(rng, micro * BF_ROWS)
    coef = rng.standard_normal(BF_DIM) * 0.01
    warm = MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(coef, has_intercept=True, label_values=[1, 0],
                                vector_col="vec", vector_size=BF_DIM - 1,
                                label_type="LONG")))

    def drain(**kw):
        op = tf.FtrlTrainStreamOp(warm, vector_col="vec", label_col="label",
                                  update_mode="batch", time_interval=2.0,
                                  **FTRL_HP, **kw).link_from(
            MemSourceStreamOp(rows, batch_size=BF_ROWS))
        return op, [_coefs(s) for _, s in drain_timed(op)[0]]

    _, fb_bare = drain()
    mon = HealthMonitor(source="ftrl")
    op, fb_mon = drain(health=mon)
    require(len(fb_bare) == len(fb_mon) == 3 and all(
        np_bits_equal(a, b) for a, b in zip(fb_bare, fb_mon)),
        "20(e): the FTRL batch drain with a monitor gives the snapshots "
        "without one, bitwise")
    pl = op.progressive_logloss()
    steps, vals = mon.series("ftrl.pv_logloss")
    require(list(steps) == [b for b, _ in pl] == list(range(1, micro + 1))
            and np.array_equal(vals, [v for _, v in pl])
            and len(mon.series("ftrl.weight_drift")[0]) == 2,
            "20(e): the FTRL monitor's series: one point a micro-batch, "
            "the drain's progressive log loss, a drift a later snapshot")
    # the per-micro-batch work of a drain, monitored or not, no host wait
    tr = op.trainer
    enc = tr.to_device(tr.encode(rows.first_n(BF_ROWS), BF_ROWS, 8))
    z, n = tr.initial_state(enc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            z, n, mg = tr.step(enc, z, n)
            ll = tf.pv_logloss_sum(mg[:BF_ROWS], enc.arrays[-1][:BF_ROWS])
            stats = tf.pv_stats(mg[:BF_ROWS], enc.arrays[-1][:BF_ROWS])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(bool(torch.isfinite(stats[:2]).all())
            and bool(torch.equal(ll, stats[0])),
            "20(e): the step's scalars are finite, and the log loss is the "
            "same bits with a monitor and without")
    out["ftrl"] = {"micro_batches": micro, "alerts": [
        a.to_dict() for a in mon.alerts], "sync_debug_error_steps": 2}
    # a NaN label: the watchdog aborts after the boundary's snapshot
    bad = dict(data, y=data["y"].copy())
    bad["y"][17] = np.nan
    with tempfile.TemporaryDirectory(prefix="e2e_health_") as d:
        mon = HealthMonitor(raise_on=("critical",), source="qn")
        try:
            lbfgs_run(bad, 6, health=mon, checkpoint_dir=d,
                      checkpoint_every=2)
            raised = None
        except HealthAlertError as e:
            raised = e
        require(raised is not None and _ckpt_tags(d) == [2],
                f"20(e): the NaN run raised HealthAlertError at the first "
                f"boundary with its snapshot on disk ({raised!r}, "
                f"{_ckpt_tags(d)})")
        recovery.reset_snapshot_records()
        res = lbfgs_run(bad, 6, health=HealthMonitor(), checkpoint_dir=d,
                        resume_from=d, checkpoint_every=2)
        loads = [r for r in recovery.snapshot_records()
                 if r["what"] == "load"]
        require(res[2] == 6 and loads and loads[0]["tag"] == 2,
                f"20(e): the snapshot resumed ({res[2]} supersteps, "
                f"{loads})")
        out["nan"] = {"alert": raised.alerts[0].to_dict(),
                      "resumed_from": 2}
    out["launches"] = _counts(*kernels)
    out["seconds"] = time.perf_counter() - t0
    print(f"20(e) health [{card}]: L-BFGS, KMeans and the FTRL batch drain "
          f"bitwise with a monitor; series = probes; the sparse step under "
          f"sync debug error; NaN: {out['nan']['alert']['message']}, resumed "
          f"from superstep 2; launches {out['launches']}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 21. FM, LDA and Word2Vec with their text front end: P3 and P4
# ---------------------------------------------------------------------------

ROW_SRC = "alink_tpu_torch/kernels/csrc/row_scatter.cu"
FM_SRC = "alink_tpu_torch/kernels/csrc/fm_score.cu"
FM_K, FM_EPOCHS, FM_BATCHES = 10, 10, 8          # FmClassifierTrainBatchOp
FM_F64_ROWS, FM_F64_EPOCHS = 20_000, 3           # the float64 card-vs-CPU gate
FM_RTOL = 1e-10
FM_DENSE_DIM = 1024                              # P4's dense layout
FM_BUCKETS = (1, 8, 32, 128, 512)
LDA_DOCS, LDA_LEN, LDA_VOCAB, LDA_K, LDA_ITERS = 11_314, 150, 30_000, 20, 10
LDA_ONLINE = dict(subsample=0.25, tau0=1.0)      # 10 supersteps that learn
LDA_ESTEP_DOCS, LDA_PREDICT_DOCS = 2048, 2000
LDA_COSINE, LDA_TIE = 0.9, 1e-3
# planted topics (of 20) whose best learned topic reaches LDA_COSINE, and
# the mean over the planted topics of their best cosine: each the lowest
# that the JAX package and the port read on the CPU at this corpus over
# seeds 0-4 (tools/lda_recovery.py; the means floored to 2 digits). Ten
# iterations leave some planted topics merged in both packages; 0.22 is
# the mean of a topic that learned nothing.
LDA_MIN_RECOVERED = {"em": 14, "gibbs": 0, "online": 10}
LDA_MIN_MEAN_COSINE = {"em": 0.91, "gibbs": 0.65, "online": 0.83}
W2V_TOKENS, W2V_VOCAB, W2V_DOC_LEN, W2V_EPOCHS = 200_000, 30_000, 1000, 2
# card against CPU, float32: tests/test_torch_nlp.py::W2V_TOL
W2V_TOL = 1e-5
W2V_F64_TOL = 1e-10
# the corpora (cut to their first tokens) of the card-vs-CPU checks: on the
# whole corpus the float32 gap grows to 4.5e-4 over 7,868 batches (my chip
# call 5), the association of cuBLAS' batched products against the CPU's
W2V_F64_TOKENS = 20_000
W2V_F32_TOKENS = (2_000, 20_000)
W2V_PROFILED_TOKENS = 20_000


class Laps:
    """Host-clock laps of a leg's stages: ``lap(name)`` records the time
    since the last lap under ``name``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.laps[name] = round(now - self.t, 3)
        self.t = now


def device_ms_seen(fn, part: str, reps: int = 10, sessions: int = 3):
    """:func:`device_ms` of ``fn``'s kernels, or ``None`` when none of
    ``sessions`` profiler sessions recorded one (after long unprofiled
    runs this process's profiler can record no kernel at all)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0) or 0)
            if us > 0 and part in e.key:
                name = re.search(r"(\w+_kernel)", e.key)
                key = name.group(1) if name else e.key
                per[key] = per.get(key, 0.0) + us / reps / 1e3
        if per:
            return sum(per.values()), per
    return None, {}


def p3_case(kr, kl, state, keys, terms):
    """P3 (``kernels/rows.py::scatter_rows``) on the card against its
    plain version (``index_add_`` on CPU copies, ordered there), bitwise
    (a NaN equal to any NaN); its times: kernel (events), device (the
    profiler's time of the kernel and, above ``SMALL_MAX``, the plan's),
    host (enqueue), plain (CPU, host clock), ``index_add_`` on the card
    (atomic, a yardstick only); the bytes bound (terms and keys read
    once, each touched row read and written once) and the adds over the
    peak rate."""
    import torch
    got = state.clone()
    kr.scatter_rows(got, keys, terms)
    want = kr.scatter_rows_plain(state.cpu().clone(), keys.cpu(),
                                 terms.cpu())
    torch.cuda.synchronize()
    ok = same_bits(got.cpu(), want)[0]
    M, C = terms.shape
    require(ok, f"P3 bitwise to its plain version at S={state.shape[0]} "
                f"C={C} M={M} {state.dtype}")
    st = state.clone()
    fn = lambda: kr.scatter_rows(st, keys, terms)    # noqa: E731
    lib = lambda: st.index_add_(0, keys, terms)       # noqa: E731
    k_ms, lib_ms = cuda_ms_turns(fn, lib, trials=9, reps=10)
    dev_ms, per = device_ms_seen(fn, "")
    h_ms = host_ms(fn, trials=9, reps=10)
    sc, kc, tc = state.cpu().clone(), keys.cpu(), terms.cpu()
    t0 = time.perf_counter()
    kr.scatter_rows_plain(sc, kc, tc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    touched = int(torch.unique(keys).numel())
    es = terms.element_size()
    nbytes = M * C * es + M * 4 + 2 * touched * C * es
    kind = "f64" if terms.dtype == torch.float64 else "f32"
    bound, by = _bound(nbytes, M * C, kind)
    return {"bitwise": True, "max_abs_err": 0.0, "kernel_ms": k_ms,
            "device_ms": dev_ms, "device_kernels": per, "host_ms": h_ms,
            "plain_ms": plain_ms, "plain_where": "CPU (index_add_)",
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "touched_rows": touched, "path": "one block"
            if M <= kr.SMALL_MAX else "plan + walk"}


def p4_case(kfm, model, idx, val, profiled=True):
    """P4 (``kernels/fm.py::fm_scores``) against its plain version on the
    card, bitwise; kernel, device and host times, the plain version's
    time and the bound (the rows' values and indices read once, each
    row of w and V that an index names read once: all of them in the
    dense layout, the distinct indices' in the sparse one; the margins
    written; 3 k + 1 products and as many adds a position)."""
    import torch
    got = kfm.fm_scores(model, idx, val)
    want = kfm.fm_scores_plain(model, idx, val)
    torch.cuda.synchronize()
    require(same_bits(got, want)[0],
            f"P4 bitwise to its plain version at {tuple(val.shape)} "
            f"{'sparse' if idx is not None else 'dense'} {val.dtype}")
    n, width = val.shape
    k = model[2].shape[1]
    fn = lambda: kfm.fm_scores(model, idx, val)       # noqa: E731
    k_ms = cuda_ms(fn, trials=9, reps=10)
    dev_ms = device_ms_seen(fn, "fm_score")[0] if profiled else None
    h_ms = host_ms(fn, trials=9, reps=10)
    plain_ms = cuda_ms(lambda: kfm.fm_scores_plain(model, idx, val),
                       trials=1, reps=1, warm=1)
    es = val.element_size()
    rows = width if idx is None else int(torch.unique(idx).numel())
    nbytes = (n * width * (es + (4 if idx is not None else 0))
              + (rows * (k + 1) + 1) * es + n * es)
    kind = "f64" if val.dtype == torch.float64 else "f32"
    bound, by = _bound(nbytes, n * width * (6 * k + 2) + n * (3 * k + 3),
                       kind)
    return {"bitwise": True, "max_abs_err": 0.0, "kernel_ms": k_ms,
            "device_ms": dev_ms, "host_ms": h_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "model_rows": rows}


def _fm_scale(m, idx, val):
    """The magnitude of FM rows' terms: |w0| + sum |x w| + 0.5 sum_f
    ((sum |x||V|)^2 + q_f) (host float64)."""
    w, V = np.asarray(m.w), np.asarray(m.V)
    sa = (np.abs(val)[..., None] * np.abs(V[idx])).sum(1)
    q = ((val ** 2)[..., None] * (V ** 2)[idx]).sum(1)
    return abs(m.w0) + np.abs(val * w[idx]).sum(1) + 0.5 * (sa ** 2 + q).sum(1)


def fm_leg(kr, kfm, kl, card):
    """21(a): FM on phase 16's 100,000 Criteo-shape rows."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.operator.batch.classification.fm_ops import (
        FmClassifierTrainBatchOp, FmModelDataConverter, FmModelMapper)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.dataproc.feature_extract import \
        extract_design
    from alink_tpu_torch.operator.common.fm.fm import (FmTrainParams,
                                                        fm_predict_margin,
                                                        fm_train)
    from alink_tpu_torch.operator.common.linear.base import encode_labels
    from alink_tpu_torch.serving import CompiledPredictor
    out = {}
    lap = Laps()
    train = criteo_softmax_rows(7, SPS_ROWS)
    held = criteo_softmax_rows(8, SPS_HELD)
    lap("rows")
    kw = dict(vector_col="features", label_col="bin", num_factor=FM_K,
              num_epochs=FM_EPOCHS)
    tables = []
    for run in range(2):
        _reset(kr, kfm, kl)
        t0 = time.perf_counter()
        op = FmClassifierTrainBatchOp(**kw).link_from(MemSourceBatchOp(train))
        tables.append(op.get_output_table())
        torch.cuda.synchronize()
        if run == 0:
            out["op_s"] = time.perf_counter() - t0
            out["main_path_launches"] = _counts(kr, kfm, kl)
    require(tables[0].to_rows() == tables[1].to_rows(),
            "two float32 FM card trainings give bitwise equal model tables")
    launches = out["main_path_launches"]
    require(launches["row_scatter"] == FM_EPOCHS * FM_BATCHES
            and launches["run_plan"] == 1,
            f"FM launched P3 once a mini-batch on one plan: {launches}")
    curve = np.asarray(op.get_side_output(0).get_output_table().col("loss"))
    out["loss_curve"] = curve.tolist()
    lap("two ops")
    # the trainer alone: ms a superstep, rows x epochs / s
    design = extract_design(train, None, "features", np.float32)
    _, y = encode_labels(train.col("bin"))
    data = {"idx": design["idx"], "val": design["val"],
            "y": y.astype(np.float32), "w": np.ones(SPS_ROWS, np.float32)}
    p = FmTrainParams(num_factors=FM_K, num_epochs=FM_EPOCHS,
                      learn_rate=0.05, batches_per_epoch=FM_BATCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm_train(data, design["dim"], p, env=MLEnvironment(device="cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out.update(train_s=secs, ms_a_superstep=secs / FM_EPOCHS * 1e3,
               rows_epochs_per_s=SPS_ROWS * FM_EPOCHS / secs)
    # float64, one mini-batch an epoch (the mask all ones): card vs CPU
    d64 = {k: (v[:FM_F64_ROWS].astype(np.float64)
               if v.dtype == np.float32 else v[:FM_F64_ROWS])
           for k, v in data.items()}
    p64 = FmTrainParams(num_factors=FM_K, num_epochs=FM_F64_EPOCHS,
                        learn_rate=0.05, batches_per_epoch=1)
    g = fm_train(d64, design["dim"], p64, env=MLEnvironment(device="cuda"))
    c = fm_train(d64, design["dim"], p64, env=MLEnvironment(device="cpu"))
    gaps = [float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                  / max(float(np.max(np.abs(np.asarray(b)))), 1e-300))
            for a, b in zip(g[:4], c[:4])]
    require(max(gaps) <= FM_RTOL,
            f"FM float64 on the card within rtol {FM_RTOL} of the CPU on "
            f"w0, w, V and the loss curve: {gaps}")
    out["f64_card_vs_cpu"] = dict(zip(("w0", "w", "V", "loss"), gaps))
    lap("trainer and f64")
    # P3 at the gradient's shapes
    dev = torch.device("cuda")
    keys = torch.from_numpy(design["idx"].reshape(-1)).to(dev)
    rng = np.random.RandomState(21)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    p3 = {}
    for dt in (torch.float32, torch.float64):
        terms = torch.randn((keys.numel(), FM_K + 2), generator=gen,
                            dtype=dt, device=dev)
        state = torch.zeros((design["dim"], FM_K + 2), dtype=dt, device=dev)
        p3[f"fm grad {'f32' if dt == torch.float32 else 'f64'}"] = p3_case(
            kr, kl, state, keys.to(torch.int32), terms)
    out["p3"] = p3
    lap("p3")
    # P4 at every bucket, sparse (the model's 39 slots padded to 40) and
    # dense (a seeded model of 1024 features), f32 and f64
    m = FmModelDataConverter().load_model(tables[0])
    p4 = {}
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        sparse_model = (torch.tensor([m.w0], dtype=dt, device=dev),
                        torch.tensor(m.w, dtype=dt, device=dev),
                        torch.tensor(m.V, dtype=dt, device=dev))
        dense_model = (torch.tensor([0.1], dtype=dt, device=dev),
                       torch.tensor(rng.standard_normal(FM_DENSE_DIM) * 0.05,
                                    dtype=dt, device=dev),
                       torch.tensor(rng.standard_normal(
                           (FM_DENSE_DIM, FM_K)) * 0.05, dtype=dt,
                           device=dev))
        for b in FM_BUCKETS:
            idx = np.zeros((b, 40), np.int32)
            val = np.zeros((b, 40))
            idx[:, :NNZ] = design["idx"][:b]
            val[:, :NNZ] = design["val"][:b]
            p4[f"sparse {tag} {b}"] = p4_case(
                kfm, sparse_model, torch.from_numpy(idx).to(dev),
                torch.tensor(val, dtype=dt, device=dev), b == 512)
            X = rng.standard_normal((b, FM_DENSE_DIM)) * (
                rng.rand(b, FM_DENSE_DIM) < 0.5)
            p4[f"dense {tag} {b}"] = p4_case(
                kfm, dense_model, None, torch.tensor(X, dtype=dt,
                                                     device=dev), b == 512)
    out["p4"] = p4
    lap("p4")
    # the model served by CompiledPredictor: labels equal to the float64
    # host map_table's outside the float32 rounding band
    mapper = FmModelMapper(tables[0].schema, held.schema,
                           Params({"prediction_col": "pred"}))
    mapper.load_model(tables[0])
    _reset(kr, kfm, kl)
    pred = CompiledPredictor(mapper, device="cuda")
    t0 = time.perf_counter()
    served = [str(v) for v in pred.predict_table(held).col("pred")]
    out["serve_s"] = time.perf_counter() - t0
    out["serving_launches"] = _counts(kr, kfm, kl)
    require(out["serving_launches"]["fm_score"] == -(-SPS_HELD // 512),
            f"P4 once a 512-row chunk: {out['serving_launches']}")
    host = [str(v) for v in mapper.map_table(held).col("pred")]
    hd = extract_design(held, None, "features", np.float64,
                        vector_size=design["dim"])
    margin = fm_predict_margin(m.w0, m.w, m.V, hd)
    clear = np.abs(margin) > 64 * U32 * _fm_scale(m, hd["idx"], hd["val"])
    require(all(a == b for a, b, ok in zip(served, host, clear) if ok),
            "CompiledPredictor FM labels equal map_table's outside the "
            "rounding band")
    out.update(in_band=int((~clear).sum()),
               held_auc=rank_auc(np.asarray(held.col("bin")), margin))
    lap("served")
    out["laps_s"] = lap.laps
    print(f"fm (a) [{card}]: op {out['op_s']:.3f} s, trainer "
          f"{out['train_s']:.3f} s ({out['ms_a_superstep']:.3f} ms a "
          f"superstep, {out['rows_epochs_per_s']:.1f} rows x epochs / s), "
          f"launches {launches}; f64 card vs CPU {out['f64_card_vs_cpu']}; "
          f"served {SPS_HELD} rows in {out['serve_s']:.3f} s "
          f"({out['in_band']} in the band, held-out AUC "
          f"{out['held_auc']:.4f}); P3 {p3}; P4 f32 512 "
          f"{p4['sparse f32 512']}; laps {lap.laps}", flush=True)
    return out


def newsgroups_corpus(seed):
    """A corpus shaped like 20 Newsgroups' training split: 11,314 docs
    of Poisson(150) tokens (at least 20) over 30,000 words, from 20
    planted topics, each a Zipf distribution over its own block of 1,500
    words; a doc draws 90 % of its tokens from its topic and 10 % from a
    second one. Returns (planted (k, V), ids, cnts (bag of words, padded),
    token arrays per doc)."""
    r = np.random.RandomState(seed)
    block = LDA_VOCAB // LDA_K
    zipf = 1.0 / np.arange(1, block + 1)
    zipf /= zipf.sum()
    perm = np.stack([r.permutation(block) for _ in range(LDA_K)])
    planted = np.zeros((LDA_K, LDA_VOCAB))
    for t in range(LDA_K):
        planted[t, t * block + perm[t]] = zipf
    lens = np.maximum(r.poisson(LDA_LEN, LDA_DOCS), 20)
    main = r.randint(0, LDA_K, LDA_DOCS)
    second = r.randint(0, LDA_K, LDA_DOCS)
    doc = np.repeat(np.arange(LDA_DOCS), lens)
    topic = np.where(r.rand(doc.size) < 0.9, main[doc], second[doc])
    rank = r.choice(block, doc.size, p=zipf)
    words = topic * block + perm[topic, rank]
    ends = np.cumsum(lens)
    docs = np.split(words, ends[:-1])
    bags = [np.unique(d, return_counts=True) for d in docs]
    L = max(len(b[0]) for b in bags)
    ids = np.zeros((LDA_DOCS, L), np.int32)
    cnts = np.zeros((LDA_DOCS, L))
    for i, (u, c) in enumerate(bags):
        ids[i, :len(u)] = u
        cnts[i, :len(c)] = c
    return planted, ids, cnts, docs


def _best_cosines(planted, word_topic):
    learned = np.asarray(word_topic, np.float64).T
    learned = learned / np.maximum(np.linalg.norm(learned, axis=1,
                                                  keepdims=True), 1e-300)
    p = planted / np.linalg.norm(planted, axis=1, keepdims=True)
    return (p @ learned.T).max(1)


def lda_leg(kr, kfm, kl, card):
    """21(b): LDA at 20 Newsgroups' shape, em / gibbs / online."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.clustering.lda_ops import (
        LdaPredictBatchOp, LdaTrainBatchOp)
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.clustering import lda as tl
    t0 = time.perf_counter()
    lap = Laps()
    planted, ids, cnts, docs = newsgroups_corpus(5)
    tokens = float(cnts.sum())
    # the planted topics' cosine with the corpus' word distribution: what
    # a topic that learned nothing would score
    freq = np.zeros(LDA_VOCAB)
    np.add.at(freq, ids.reshape(-1), cnts.reshape(-1))
    out = {"corpus_s": time.perf_counter() - t0, "tokens": tokens,
           "max_distinct": int(ids.shape[1]),
           "unlearned_cosine": float(_best_cosines(planted,
                                                   freq[:, None]).mean())}
    env = MLEnvironment(device="cuda")
    methods = {
        "em": lambda: tl.em_lda_train(ids, cnts, LDA_K, LDA_VOCAB,
                                      num_iter=LDA_ITERS, env=env, seed=3),
        "gibbs": lambda: tl.gibbs_lda_train(ids, cnts, LDA_K, LDA_VOCAB,
                                            num_iter=LDA_ITERS, env=env,
                                            seed=3),
        "online": lambda: tl.online_lda_train(
            ids, cnts, LDA_K, LDA_VOCAB, num_iter=LDA_ITERS, env=env,
            seed=3, **LDA_ONLINE)}
    recs, launches = {}, {}
    for name, run in methods.items():
        _reset(kr, kfm, kl)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches[name] = _counts(kr, kfm, kl)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        b = run()
        require(all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(a, b)),
                f"LDA {name}: two card runs bitwise")
        wt = (a[0] / a[0].sum(1, keepdims=True)).T if name == "online" \
            else a[0]
        cos = _best_cosines(planted, wt)
        recovered = int((cos >= LDA_COSINE).sum())
        require(recovered >= LDA_MIN_RECOVERED[name]
                and cos.mean() >= LDA_MIN_MEAN_COSINE[name],
                f"LDA {name}: {recovered} planted topics recovered (best "
                f"cosine >= {LDA_COSINE}), want {LDA_MIN_RECOVERED[name]}; "
                f"mean best cosine {cos.mean()}, want "
                f"{LDA_MIN_MEAN_COSINE[name]}")
        rec = {"s": secs, "ms_a_superstep": secs / LDA_ITERS * 1e3,
               "tokens_per_s": tokens * LDA_ITERS / secs,
               "peak_gib": peak, "recovered": recovered,
               "best_cosines": np.sort(cos).round(4).tolist(),
               "log_perplexity": float(a[-1]), "launches": launches[name]}
        if name == "gibbs":
            require(float(a[0].sum()) == tokens == float(a[1].sum()),
                    "Gibbs' word-topic counts total the token count exactly")
        else:
            require(launches[name]["row_scatter"] == LDA_ITERS
                    and launches[name]["run_plan"] == 1,
                    f"LDA {name}: P3 once a superstep on one plan: "
                    f"{launches[name]}")
        recs[name] = rec
    out["methods"] = recs
    lap("trainers")
    # the float64 E-step, card against CPU, from one gamma0
    n = LDA_ESTEP_DOCS
    r = np.random.RandomState(4)
    eEb = r.rand(LDA_K, LDA_VOCAB) + 0.05
    g0 = r.gamma(100.0, 0.01, (n, LDA_K))
    res = []
    for where in ("cuda", "cpu"):
        i_t = torch.from_numpy(ids[:n]).to(where)
        c_t = torch.from_numpy(cnts[:n]).to(where)
        res.append(tl._e_step(
            i_t, c_t, torch.from_numpy(eEb).to(where), 0.05,
            torch.from_numpy(g0).to(where), 20,
            tl.corpus_support(i_t, c_t, LDA_VOCAB)))
    gaps = [float((x.cpu() - y).abs().max() / y.abs().max())
            for x, y in zip(res[0], res[1])]
    require(max(gaps) <= 1e-10,
            f"the float64 E-step on the card within rtol 1e-10 of the CPU's "
            f"(gamma, sstats): {gaps}")
    out["estep_f64_gap"] = gaps
    lap("estep f64")
    # P3 at the E-step's sum (M = the corpus' bag entries, k columns)
    keys = torch.from_numpy(ids.reshape(-1)[cnts.reshape(-1) != 0]).cuda()
    terms = torch.from_numpy(r.rand(keys.numel(), LDA_K).astype(
        np.float32)).cuda()
    out["p3"] = {"lda segment_sum f32": p3_case(
        kr, kl, torch.zeros((LDA_VOCAB, LDA_K), device="cuda"), keys,
        terms)}
    lap("p3")
    # the ops: em trained through LdaTrainBatchOp on the first docs' text,
    # the topics of LdaPredictBatchOp on the card equal to the CPU mapper's
    texts = MTable({"doc": [" ".join(f"w{t}" for t in d) for d in docs]},
                   "doc STRING")
    lap("text")
    sub = MTable({"doc": list(texts.col("doc"))[:LDA_PREDICT_DOCS]},
                 "doc STRING")
    t1 = time.perf_counter()
    op = LdaTrainBatchOp(selected_col="doc", topic_num=LDA_K,
                         num_iter=LDA_ITERS, seed=3).link_from(
        MemSourceBatchOp(sub))
    out["op_s"] = time.perf_counter() - t1
    preds = {}
    for where in ("cuda", "cpu"):
        preds[where] = LdaPredictBatchOp(
            selected_col="doc", prediction_col="t",
            prediction_detail_col="p", device=where).link_from(
            op, MemSourceBatchOp(sub)).get_output_table()
    probs = np.asarray([json.loads(s) for s in preds["cpu"].col("p")])
    top2 = np.sort(probs, 1)[:, -2:]
    away = top2[:, 1] - top2[:, 0] > LDA_TIE
    require(np.array_equal(np.asarray(preds["cuda"].col("t"))[away],
                           np.asarray(preds["cpu"].col("t"))[away]),
            "LdaPredictBatchOp's topics on the card equal the CPU mapper's "
            "away from ties")
    out["predict_ties"] = int((~away).sum())
    out["launches"] = launches
    lap("ops")
    out["laps_s"] = lap.laps
    print(f"lda (b) [{card}]: {int(tokens)} tokens, {out['max_distinct']} "
          f"distinct words a doc at most; {recs}; E-step f64 gap {gaps}; "
          f"op {out['op_s']:.3f} s; predict ties {out['predict_ties']}; "
          f"laps {lap.laps}", flush=True)
    return out, texts


def text8_corpus(seed):
    """A text8-shaped corpus: Zipf(1) draws over 30,000 word ranks,
    200,000 tokens in rows of 1,000."""
    from alink_tpu_torch.common.mtable import MTable
    r = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, W2V_VOCAB + 1)
    p /= p.sum()
    words = r.choice(W2V_VOCAB, W2V_TOKENS, p=p)
    rows = [" ".join(f"t{w}" for w in words[i:i + W2V_DOC_LEN])
            for i in range(0, W2V_TOKENS, W2V_DOC_LEN)]
    return MTable({"doc": rows}, "doc STRING")


def w2v_layout(table, p):
    """``word2vec_train``'s own vocabulary (by count, then word, at
    ``min_count``), skip-gram pairs and Huffman paths of ``table``'s
    ``doc`` column: (vocab, pairs, points)."""
    from alink_tpu_torch.operator.common.nlp.text import _tokens
    from alink_tpu_torch.operator.common.nlp.word2vec import (build_huffman,
                                                              skipgram_pairs)
    counts = {}
    for v in table.col("doc"):
        for t in _tokens(v):
            counts[t] = counts.get(t, 0) + 1
    vocab = [w for w, c in sorted(counts.items(), key=lambda kv: (-kv[1],
                                                                  kv[0]))
             if c >= p.min_count]
    index = {w: i for i, w in enumerate(vocab)}
    docs = [[index[t] for t in _tokens(v) if t in index]
            for v in table.col("doc")]
    pairs = skipgram_pairs([d for d in docs if len(d) > 1], p.window, p.seed)
    points, _, _ = build_huffman([counts[w] for w in vocab])
    return vocab, pairs, points


def w2v_p3_inputs(vocab, pairs, points, p, dev):
    """P3's inputs at the `in` and `out` scatters of Word2Vec's first
    batch: (name, state, keys, terms), seeded float32 states and terms."""
    import torch
    r = np.random.RandomState(9)
    pr = pairs[:p.batch_size]
    cases = []
    for name, state_rows, keys in (
            ("w2v in", len(vocab), pr[:, 0].copy()),
            ("w2v out", max(len(vocab) - 1, 1),
             points[pr[:, 1]].reshape(-1))):
        keys = torch.from_numpy(keys.astype(np.int32)).to(dev)
        terms = torch.from_numpy(r.standard_normal(
            (keys.numel(), p.vector_size)).astype(np.float32)).to(dev)
        state = torch.from_numpy(r.standard_normal(
            (state_rows, p.vector_size)).astype(np.float32)).to(dev)
        cases.append((name, state, keys, terms))
    return cases


def w2v_leg(kr, kfm, kl, card):
    """21(c): Word2Vec on a text8-shaped corpus at the op's widths. P3's
    cases and the profiled run come first: after the long unprofiled
    trainings this process's profiler records no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.nlp.word2vec import (
        Word2VecParams, word2vec_train)
    table = text8_corpus(8)
    p = Word2VecParams(num_iter=W2V_EPOCHS)          # the op's defaults
    out = {}
    vocab, pairs, points = w2v_layout(table, p)
    batches = -(-pairs.shape[0] // p.batch_size)
    L = points.shape[1]
    # P3 at the `in` and `out` scatters' shapes of the first batch
    p3 = {}
    for name, state, keys, terms in w2v_p3_inputs(
            vocab, pairs, points, p, torch.device("cuda")):
        p3[f"{name} f32"] = p3_case(kr, kl, state, keys, terms)
    out["p3"] = p3
    # device ops a batch: the profiler over one epoch of the corpus cut
    # to its first rows
    small = type(table)({"doc": list(table.col("doc"))[
        :W2V_PROFILED_TOKENS // W2V_DOC_LEN]}, "doc STRING")
    ps = Word2VecParams(num_iter=1)
    word2vec_train(small, "doc", ps, env=MLEnvironment(device="cuda"))
    torch.cuda.synchronize()
    _reset(kr, kfm, kl)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        word2vec_train(small, "doc", ps, env=MLEnvironment(device="cuda"))
        torch.cuda.synchronize()
    small_batches = _counts(kr, kfm, kl)["row_scatter"] // 2
    ops = sum(int(e.count) for e in prof.key_averages()
              if float(getattr(e, "self_device_time_total", 0) or 0) > 0)
    out.update(profiled_batches=small_batches,
               device_ops_a_batch=ops / max(small_batches, 1))
    # the main path: two float32 trainings on the card, bitwise
    runs = []
    for run in range(2):
        _reset(kr, kfm, kl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(word2vec_train(table, "doc", p,
                                   env=MLEnvironment(device="cuda")))
        torch.cuda.synchronize()
        if run == 0:
            out["s"] = time.perf_counter() - t0
            out["main_path_launches"] = _counts(kr, kfm, kl)
    require(runs[0][0] == runs[1][0] == vocab
            and np.array_equal(runs[0][1], runs[1][1]),
            "two Word2Vec card trainings bitwise")
    vec = runs[0][1]
    launches = out["main_path_launches"]
    require(launches["row_scatter"] == 2 * batches * W2V_EPOCHS,
            f"Word2Vec launched P3 twice a batch: {launches}, {batches} "
            f"batches an epoch")
    def cut(tokens):
        return type(table)({"doc": list(table.col("doc"))[
            :tokens // W2V_DOC_LEN]}, "doc STRING")

    def gap_of(tokens, dtype):
        a = word2vec_train(cut(tokens), "doc", p,
                           env=MLEnvironment(device="cuda"), dtype=dtype)[1]
        b = word2vec_train(cut(tokens), "doc", p,
                           env=MLEnvironment(device="cpu"), dtype=dtype)[1]
        return float(np.abs(a - b).max() / np.abs(b).max())

    # float64 on the card against the CPU: the same arithmetic, so a gap
    # past rounding is a fault
    t0 = time.perf_counter()
    gap = gap_of(W2V_F64_TOKENS, torch.float64)
    out["f64_check_s"] = time.perf_counter() - t0
    require(gap <= W2V_F64_TOL,
            f"Word2Vec float64 on the card within {W2V_F64_TOL} of the CPU's "
            f"largest |vector| ({W2V_F64_TOKENS} tokens): {gap}")
    # float32, card against CPU: within the CPU test's tolerance on the
    # shorter cut; the longer one printed
    f32 = {t: gap_of(t, torch.float32) for t in W2V_F32_TOKENS}
    require(f32[W2V_F32_TOKENS[0]] <= W2V_TOL,
            f"Word2Vec float32 on the card within {W2V_TOL} of the CPU's "
            f"largest |vector| ({W2V_F32_TOKENS[0]} tokens): {f32}")
    out["f32_card_vs_cpu"] = f32
    out.update(vocab=len(vocab), pairs=int(pairs.shape[0]), levels=int(L),
               batches_an_epoch=batches, f64_card_vs_cpu=gap,
               pairs_per_s=pairs.shape[0] * W2V_EPOCHS / out["s"],
               ms_an_epoch=out["s"] / W2V_EPOCHS * 1e3)
    print(f"w2v (c) [{card}]: {out['vocab']} words, {out['pairs']} pairs, "
          f"L {L}, {batches} batches an epoch; {out['s']:.3f} s "
          f"({out['pairs_per_s']:.1f} pairs/s, {out['ms_an_epoch']:.3f} ms "
          f"an epoch), {out['device_ops_a_batch']:.1f} device ops a batch; "
          f"float64 card vs CPU {gap} ({out['f64_check_s']:.3f} s), "
          f"float32 {f32}; P3 {p3}", flush=True)
    return out


def graft_legs(kr, kfm, kl, texts, card):
    """21(d): the vectorizers on (b)'s corpus, and dryrun_multichip's
    three legs (__graft_entry__.py:187-220) at their own shapes."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.feature.feature_ops import \
        murmur32_cells
    from alink_tpu_torch.operator.common.clustering.lda import \
        gibbs_lda_train
    from alink_tpu_torch.operator.common.fm.fm import FmTrainParams, fm_train
    from alink_tpu_torch.operator.common.nlp.vectorizer import (
        DocCountVectorizerModelConverter,
        DocHashCountVectorizerModelConverter, train_doc_count_vectorizer,
        train_doc_hash_count_vectorizer)
    from alink_tpu_torch.operator.common.nlp.word2vec import (
        Word2VecParams, word2vec_train)
    out = {}
    t0 = time.perf_counter()
    dc = DocCountVectorizerModelConverter().load_model(
        train_doc_count_vectorizer(texts, "doc"))
    dh = DocHashCountVectorizerModelConverter().load_model(
        train_doc_hash_count_vectorizer(texts, "doc", num_features=1 << 18))
    out["vectorizers_s"] = time.perf_counter() - t0
    # against counts made another way: numpy's unique over each doc's
    # words, the native MurmurHash3 for the hashed slots
    n_docs = texts.num_rows
    toks = [np.asarray(str(d).split()) for d in texts.col("doc")]
    words, df = np.unique(np.concatenate([np.unique(t) for t in toks]),
                          return_counts=True)
    order = np.lexsort((words, -df))
    require(dc.vocab == list(words[order])
            and np.allclose(dc.idf, np.log((1.0 + n_docs)
                                           / (1.0 + df[order])),
                            rtol=1e-14, atol=0),
            "DocCountVectorizer's vocabulary and idf equal numpy's counts")
    slot_of = dict(zip(words.tolist(), murmur32_cells(
        np.asarray([w.encode() for w in words]), mod=1 << 18).tolist()))
    hdf = {}
    for t in toks:
        for s in {slot_of[w] for w in np.unique(t).tolist()}:
            hdf[s] = hdf.get(s, 0) + 1
    require(sorted(dh.idf_map) == sorted(hdf) and all(
        abs(dh.idf_map[s] - np.log((1.0 + n_docs) / (1.0 + c)))
        <= 1e-14 * abs(dh.idf_map[s]) for s, c in hdf.items()),
        "DocHashCountVectorizer's slots and idf equal the native hash's "
        "counts")
    out.update(vocab=len(dc.vocab), hashed_slots=len(dh.idf_map))
    # dryrun_multichip's legs, one device
    _reset(kr, kfm, kl)
    rng = np.random.RandomState(0)
    X = rng.randn(8, 16).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    w = np.ones(8, np.float32)
    env = MLEnvironment(device="cuda")
    ids_l = rng.randint(0, 12, (2, 6)).astype(np.int32)
    wt_l, _, _, _, _, perp_l = gibbs_lda_train(
        ids_l, np.ones((2, 6), np.float64), k=2, V=12, num_iter=2, env=env)
    require(np.isfinite(perp_l) and wt_l.shape == (12, 2),
            "dryrun_multichip's Gibbs LDA leg")
    wv_words = [f"tok{i}" for i in range(16)]
    rows = [(" ".join(rng.choice(wv_words, 8)),) for _ in range(4)]
    vocab_w, vecs_w = word2vec_train(
        MTable(rows, "doc STRING"), "doc",
        Word2VecParams(vector_size=4, min_count=1, num_iter=2, window=2,
                       batch_size=16), env=env)
    require(np.isfinite(vecs_w).all() and vecs_w.shape[1] == 4,
            "dryrun_multichip's Word2Vec leg")
    w0_fm, w_fm, V_fm, curve_fm, _ = fm_train(
        {"X": X[:, :8], "y": y, "w": w}, 8,
        FmTrainParams(num_factors=2, num_epochs=2), env=env)
    require(np.isfinite(w_fm).all() and np.isfinite(V_fm).all()
            and w_fm.shape == (8,) and V_fm.shape == (8, 2),
            "dryrun_multichip's FM leg")
    torch.cuda.synchronize()
    out["legs"] = {"lda_log_perplexity": float(perp_l),
                   "w2v_shape": list(vecs_w.shape),
                   "fm_loss": np.asarray(curve_fm).tolist()}
    out["legs_launches"] = _counts(kr, kfm, kl)
    print(f"graft (d) [{card}]: vectorizers {out['vectorizers_s']:.3f} s "
          f"({out['vocab']} words, {out['hashed_slots']} hashed slots) equal "
          f"to numpy's and the native hash's counts; legs {out['legs']}",
          flush=True)
    return out


def phase_text(kernels, card):
    """21: FM, LDA and Word2Vec on the card. ``kernels`` are the kernel
    modules ``rows``, ``fm`` and ``linear`` (the plan's)."""
    import torch
    kr, kfm, kl = kernels
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is off for the dense products")
    t0 = time.perf_counter()
    out = {"card": card}
    legs = {}
    t1 = time.perf_counter()
    out["fm"] = fm_leg(kr, kfm, kl, card)
    legs["fm"], t1 = time.perf_counter() - t1, time.perf_counter()
    out["lda"], texts = lda_leg(kr, kfm, kl, card)
    legs["lda"], t1 = time.perf_counter() - t1, time.perf_counter()
    out["w2v"] = w2v_leg(kr, kfm, kl, card)
    legs["w2v"], t1 = time.perf_counter() - t1, time.perf_counter()
    out["graft"] = graft_legs(kr, kfm, kl, texts, card)
    legs["graft"] = time.perf_counter() - t1
    out["leg_seconds"] = legs
    print(f"phase 21 legs (s): {legs}", flush=True)
    launches = {"row_scatter": 0, "fm_score": 0, "run_plan": 0}
    for part in ([out["fm"]["main_path_launches"],
                  out["fm"]["serving_launches"],
                  out["w2v"]["main_path_launches"],
                  out["graft"]["legs_launches"]]
                 + list(out["lda"]["launches"].values())):
        for k in launches:
            launches[k] += part.get(k, 0)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import DenseVector, SparseVector
    from alink_tpu_torch.kernels import _build
    from alink_tpu_torch.kernels import ftrl as kf
    from alink_tpu_torch.kernels import serve as ks
    from alink_tpu_torch.kernels import tree_hist as kh
    from alink_tpu_torch.serving import PredictServer

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    probe = start_chain_probe(_build)
    _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a)")
    for name in _build.sources():
        print(f"build log {name}:\n{_build.build_log(name).strip()}")
    lat = add_latency(*probe)
    print(f"dependent add latency (cycles) and SM clock (MHz): {lat}")

    # -- 3. kernels against their plain versions -------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    parity = phase_kernels(ks, rng, dev, lat)
    dense_edge_rec = parity.pop("serve_dense_edges")
    sparse_edge_rec = parity.pop("serve_sparse_edges")
    for name, modes in parity.items():
        for mode, rec in modes.items():
            print(f"{name} {mode}: " + " ".join(
                f"{k}={v}" for k, v in rec.items()), flush=True)

    # -- 4. the main path: Criteo-shape sparse LR -------------------------
    coef = rng.standard_normal(FEATURES + 1) * 0.05
    t0 = time.perf_counter()
    mapper = build_mapper(coef, FEATURES)
    print(f"model table save+load ({FEATURES} features): "
          f"{time.perf_counter() - t0:.3f} s")
    idx, val = criteo_rows(rng, N_REQUESTS)
    order = np.argsort(idx, axis=1)
    idx = np.take_along_axis(idx, order, 1)
    val = np.take_along_axis(val, order, 1)
    vecs = np.empty(N_REQUESTS, object)
    vecs[:] = [SparseVector(FEATURES, idx[i], val[i])
               for i in range(N_REQUESTS)]
    req = MTable({"vec": vecs}, "vec VECTOR")
    terms = np.abs(val * coef[1:][idx]).sum(1) + abs(coef[0])
    sp_launch, gpu, out, secs = check_path(ks, "serve_sparse", mapper, req,
                                           terms)
    print(f"sparse main path: {N_REQUESTS} rows in {secs:.4f} s "
          f"({N_REQUESTS / secs:.1f} rows/s), {sp_launch} kernel launches")

    # PredictServer: 64 single-row requests from 4 client threads
    ks.reset_launch_counts()
    answers = {}

    def client(lo, hi):
        futs = [(j, srv.submit(req.row(j))) for j in range(lo, hi)]
        for j, f in futs:
            answers[j] = f.result(60)

    per = N_SINGLE // CLIENTS
    with PredictServer(gpu) as srv:
        threads = [threading.Thread(target=client, args=(c * per,
                                                         (c + 1) * per))
                   for c in range(CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    require(not any(th.is_alive() for th in threads), "server clients done")
    server_launches = ks.launch_counts()["serve_sparse"]
    require(server_launches > 0, "PredictServer launched no kernel")
    require(len(answers) == N_SINGLE, "every request answered")
    for j, got in answers.items():
        require([str(v) for v in got] == [str(v) for v in out.row(j)],
                f"server answer {j} equals its predict_table row")
    print(f"PredictServer: {N_SINGLE} requests from {CLIENTS} threads "
          f"answered in {server_launches} kernel launches")
    sparse_buckets = bucket_latency(gpu, req)
    sparse_split = dispatch_breakdown(gpu, req)

    # the dense kernel's path: a 1024-wide model
    dim = DENSE_SHAPE[1]
    coef_d = rng.standard_normal(dim + 1) * 0.05
    Xd = rng.standard_normal((N_REQUESTS, dim))
    dvecs = np.empty(N_REQUESTS, object)
    dvecs[:] = [DenseVector(x) for x in Xd]
    dreq = MTable({"vec": dvecs}, "vec VECTOR")
    dterms = np.abs(Xd * coef_d[1:]).sum(1) + abs(coef_d[0])
    de_launch, dgpu, _, dsecs = check_path(
        ks, "serve_dense", build_mapper(coef_d, dim), dreq, dterms)
    print(f"dense path: {N_REQUESTS} rows in {dsecs:.4f} s "
          f"({N_REQUESTS / dsecs:.1f} rows/s), {de_launch} kernel launches")
    dense_buckets = bucket_latency(dgpu, dreq)
    dense_split = dispatch_breakdown(dgpu, dreq)
    for kind, table in (("sparse", sparse_buckets), ("dense", dense_buckets)):
        for b, r in table.items():
            print(f"{kind} bucket {b}: p50 {r['p50_ms']} ms, "
                  f"{r['rows_per_s']} rows/s")
    for kind, split in (("sparse", sparse_split), ("dense", dense_split)):
        print(f"{kind} 512-row dispatch, median ms per stage: {split}")

    # -- 6. the FTRL state kernels against their plain versions ----------
    ftrl_parity = phase_ftrl_kernels(kf, rng, dev, lat)
    host_parts = ftrl_parity.pop("gather_host_parts_ms")
    walk_steps_rec = ftrl_parity.pop("walk_steps")
    print(f"the strict steps on a micro-batch K does not divide: "
          f"{walk_steps_rec}", flush=True)
    for name, shapes in ftrl_parity.items():
        for key, rec in shapes.items():
            print(f"{name} {key}: " + " ".join(
                f"{k}={v}" for k, v in rec.items()), flush=True)
    print(f"gather host parts (ms per call): {host_parts}", flush=True)

    # -- 7. the FTRL main path: online training on Criteo-shape rows -----
    ftrl = phase_ftrl_main(kf, ks, rng)

    # -- 8. the level-histogram kernel against its plain version ---------
    tree_parity, tree_regs = phase_tree_hist(kh, _build.build_log("tree_hist"),
                                             dev)

    # -- 9. the GBDT main path: adult-shape training on the card ---------
    gbdt, gbdt_train_op, _ = phase_gbdt_main(kh)

    # -- 10. tree serving --------------------------------------------------
    tree_serving = phase_tree_serving(gbdt_train_op)

    # -- 11. an out-of-range slot or bin fails loudly on the card ---------
    bad_slots = phase_bad_slots()
    print(f"out-of-range indices: {bad_slots}")

    # -- 12. linear training: gradient kernel, L-BFGS, the chained path ---
    from alink_tpu_torch.kernels import linear as kl
    t0 = time.perf_counter()
    grad_parity = phase_linear_grad(kl, rng, lat)
    for key, rec in grad_parity.items():
        print(f"linear_grad {key}: " + " ".join(
            f"{k}={v}" for k, v in rec.items()), flush=True)
    lbfgs = phase_lbfgs(kl, ks, args.seed)
    lr_main = phase_lr_main(kl, ks, kf)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 14. FTRL's batch mode: P2, the batch steps, bench_ftrl's stream --
    # (before phase 13: after that phase's profiled drain, of over 130,000
    # kernel launches, torch.profiler in the same process recorded 0 to 2
    # of 20 ``scatter_walk`` launches a session)
    t0 = time.perf_counter()
    scatter_parity, batch = phase_batch((kl, kf), rng, lat, card)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13. the FTRLExample loop end to end ------------------------------
    t0 = time.perf_counter()
    example = phase_example((ks, kl, kf, kh), args.seed, card)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 15. the ingest path: files, the native parser, L-BFGS on the card
    t0 = time.perf_counter()
    ingest = phase_ingest((ks, kl), card)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 16. the rest of the linear family and KMeans ---------------------
    t0 = time.perf_counter()
    family = phase_family_main((ks, kl), card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 17. durability: kill-and-resume on the card ----------------------
    t0 = time.perf_counter()
    durability = phase_durability((ks, kl, kf), card)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 18. ALS, the operators and the stream twins ----------------------
    t0 = time.perf_counter()
    als = phase_als((ks, kl, kf, kh), card)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 19. the serving tier: serve_logreg, serve_hot_swap, serve_chaos --
    serving = phase_serving((ks, kl, kf, kh), card)
    print_serving(serving)

    # -- 20. the online DAG (bench_serve_online_e2e) and health on the card
    online = phase_online((ks, kl, kf, kh), card)
    print_online(online)
    health = phase_health((ks, kl, kf, kh), card)

    # -- 21. FM, LDA and Word2Vec with their text front end: P3 and P4 ----
    from alink_tpu_torch.kernels import fm as kfm
    from alink_tpu_torch.kernels import rows as kr
    text = phase_text((kr, kfm, kl), card)
    print(f"phase 21: {text['seconds']:.1f} s, launches {text['launches']}",
          flush=True)

    # -- the record -------------------------------------------------------
    launches = {"serve_dense": de_launch, "serve_sparse": sp_launch}
    replaces = {"serve_dense": "alink_tpu/kernels/serve.py:221",
                "serve_sparse": "alink_tpu/kernels/serve.py:242"}
    kernels = []
    for name in ("serve_dense", "serve_sparse"):
        f32 = parity[name]["f32"]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in parity[name].values()),
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "bitwise": all(r["bitwise"] for r in parity[name].values()),
            "kernel_ms": f32["kernel_ms"], "device_ms": f32["device_ms"],
            "host_ms": f32["host_ms"],
            "library_device_ms": f32["library_device_ms"],
            "library_host_ms": f32["library_host_ms"],
            "modes": {m: {k: r[k] for k in ("kernel_ms", "device_ms",
                                            "host_ms", "bound_ms")
                          + (("chain_bound_ms",)
                             if name == "serve_dense" else ())}
                      for m, r in parity[name].items()}})
    kernels[0]["chain_bound_ms"] = parity["serve_dense"]["f32"][
        "chain_bound_ms"]
    kernels[0]["add_latency"] = lat
    kernels[0]["edges"] = dense_edge_rec
    kernels[1]["edges"] = sparse_edge_rec
    # the FTRL kernels' record: each at the shape of the path that
    # counts it (sample mode for gather and scatter-add, chained for the
    # correction), in f32; every shape's times are in "shapes"
    ftrl_rec = (
        ("ftrl_gather", "alink_tpu/kernels/ftrl.py:90",
         f"f32 staleness M={FTRL_M['staleness']} C=2",
         ftrl["staleness"]["launches"]["ftrl_gather"]),
        ("ftrl_gather_pair", "alink_tpu/kernels/ftrl.py:90",
         f"f32 sample M={FTRL_M['sample']}",
         ftrl["sample"]["main_path_launches"]["ftrl_gather_pair"]),
        ("ftrl_scatter_add", "alink_tpu/kernels/ftrl.py:129",
         f"f32 sample M={FTRL_M['sample']} C=1",
         ftrl["sample"]["main_path_launches"]["ftrl_scatter_add"]),
        ("ftrl_walk", "alink_tpu/kernels/ftrl.py:190",
         f"f32 sample K=4 w={FTRL_WIDTH} criteo",
         ftrl["sample"]["main_path_launches"]["ftrl_walk"]))
    for name, where, key, count in ftrl_rec:
        r = ftrl_parity[name][key]
        kernels.append({
            "name": name, "route": "cuda", "source": FTRL_SRC,
            "replaces": where, "launches": count,
            "max_abs_err": max(v["max_abs_err"]
                               for v in ftrl_parity[name].values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": True,
            "kernel_ms": r["kernel_ms"], "device_ms": r["device_ms"],
            "shape": key,
            "shapes": {k: {f: v[f] for f in (
                "kernel_ms", "device_ms", "host_ms", "plain_ms",
                "library_ms", "library_device_ms", "library_host_ms",
                "bound_ms", "chain_bound_ms", "raw_bits_equal") if f in v}
                for k, v in ftrl_parity[name].items()}})
        if name.startswith("ftrl_gather"):
            kernels[-1].update(host_ms=r["host_ms"],
                               library_host_ms=r["library_host_ms"])
    kernels[2]["host_parts_ms"] = host_parts
    next(k for k in kernels if k["name"] == "ftrl_gather_pair")[
        "shapes"].update(
        {f"batch {k}": {f: v[f] for f in (
            "kernel_ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "library_device_ms", "library_host_ms", "bound_ms")}
         for k, v in batch["gather_pair"].items()})
    walk = ftrl_parity["ftrl_walk"][ftrl_rec[-1][2]]
    kernels[-1].update(host_ms=walk["host_ms"],
                       chain_bound_ms=walk["chain_bound_ms"],
                       steps=walk_steps_rec,
                       chained_launches=ftrl["chained"]["launches"][
                           "ftrl_walk"])
    # the histogram kernel's record: at the main path's deepest level
    tkey = f"level n={ADULT_N} F={ADULT_F} nodes=32 bins={GBDT_BINS} m=3"
    r = tree_parity[tkey]
    kernels.append({
        "name": "tree_hist", "route": "cuda", "source": TREE_SRC,
        "replaces": "alink_tpu/operator/common/tree/hist.py:262",
        "launches": gbdt["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in tree_parity.values()),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "bitwise": True,
        "kernel_ms": r["kernel_ms"], "device_ms": r["device_ms"],
        "shape": tkey, "ptxas": tree_regs,
        "shapes": {k: {f: v[f] for f in ("kernel_ms", "device_ms",
                                           "plain_ms", "library_ms",
                                           "bound_ms", "scratch_bytes")}
                   for k, v in tree_parity.items()}})
    # the port-only gradient kernel: no TPU kernel; it replaces the JAX
    # package's padded-COO scatter-add (and the field-blocked one-hot
    # product), at the field-blocked bench_logreg shape
    r = grad_parity["fieldblock f32"]
    kernels.append({
        "name": "linear_grad", "route": "cuda", "source": LR_SRC,
        "replaces": "alink_tpu/operator/common/optim/objfunc.py:220",
        "port_only": True,
        "launches": lr_main["main_path_launches"]["linear_grad"],
        "max_abs_err": max(v["max_abs_err"] for v in grad_parity.values()),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "bitwise": True,
        "kernel_ms": r["kernel_ms"], "device_ms": r["device_ms"],
        "host_ms": r["host_ms"], "chain_bound_ms": r["chain_bound_ms"],
        "shape": f"fieldblock f32 {LR_ROWS} x {LR_FIELDS + 1} over "
                 f"{(LR_FIELDS + 1) * LR_FIELD_SIZE}",
        "shapes": {k: {f: v[f] for f in (
            "kernel_ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "chain_bound_ms",
            "chain_fraction", "longest_run", "heavy_runs", "medium_runs",
            "raw_bits_equal") if f in v}
            for k, v in grad_parity.items()}})
    # the port-only ordered scatter-add: no TPU kernel; it replaces the JAX
    # package's batch update z.at[li].add(dz), at bench_ftrl's COO shape
    r = scatter_parity["coo f32"]
    kernels.append({
        "name": "scatter_walk", "route": "cuda", "source": LR_SRC,
        "replaces": "alink_tpu/operator/stream/onlinelearning/ftrl.py:576",
        "port_only": True,
        "launches": batch["main_path"]["main_path_launches"]["scatter_walk"],
        "max_abs_err": max(v["max_abs_err"]
                           for v in scatter_parity.values()),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "bitwise": True,
        "kernel_ms": r["kernel_ms"], "device_ms": r["device_ms"],
        "host_ms": r["host_ms"], "chain_bound_ms": r["chain_bound_ms"],
        "wrapper_ms": r["wrapper_ms"], "plan_ms": r["plan_ms"],
        "shape": f"coo f32 {BF_ROWS} x 40 over {BF_DIM}",
        "shapes": {k: {f: v[f] for f in (
            "kernel_ms", "device_ms", "host_ms", "wrapper_ms", "plan_ms",
            "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "chain_bound_ms",
            "chain_fraction", "longest_run", "runs", "heavy_runs",
            "medium_runs", "raw_bits_equal") if f in v}
            for k, v in scatter_parity.items()}})
    # the plan both ordered kernels walk, built on the card: no TPU kernel
    # (the JAX package's scatter-adds need no plan); at the same shape. Its
    # plain version is run_plan_plain on the card; no one PyTorch call
    # computes a plan
    kernels.append({
        "name": "run_plan", "route": "cuda", "source": PLAN_SRC,
        "replaces": "alink_tpu/operator/stream/onlinelearning/ftrl.py:576",
        "port_only": True,
        "launches": batch["main_path"]["main_path_launches"]["run_plan"],
        "max_abs_err": 0, "ms": r["plan_ms"], "plain_ms": r["plan_plain_ms"],
        "plain_where": "card (torch ops and one host read)",
        "bound_ms": r["plan_bound_ms"], "bound_by": r["plan_bound_by"],
        "library_ms": None, "plan_equal": True,
        "device_ms": r["plan_device_ms"], "host_ms": r["plan_host_ms"],
        "device_kernels": r["plan_device_kernels"],
        "shape": f"coo {BF_ROWS} x 40 over {BF_DIM}",
        "shapes": {k: {f: v[f] for f in (
            "plan_ms", "plan_device_ms", "plan_host_ms", "plan_plain_ms",
            "plan_bound_ms") if f in v}
            for k, v in scatter_parity.items() if "plan_ms" in v}})
    for rec in kernels:
        rec["batch_mode_launches"] = {
            "main_path": batch["main_path"]["main_path_launches"].get(
                rec["name"], 0),
            "bench_stream": batch["stream"]["stream_launches"].get(
                rec["name"], 0)}
    kernels[1]["training_launches"] = lr_main["training_launches"][
        "serve_sparse"]
    kernels[1]["lr_main_path_launches"] = lr_main["main_path_launches"][
        "serve_sparse"]
    for rec in kernels:
        rec["example_loop_launches"] = example["launches"][rec["name"]]
        rec["ingest_launches"] = ingest["launches"].get(rec["name"], 0)
        rec["linear_family_launches"] = family["launches"].get(rec["name"],
                                                               0)
        rec["durability_launches"] = durability["launches"].get(rec["name"],
                                                                0)
        rec["als_launches"] = als["launches"].get(rec["name"], 0)
        rec["serving_tier_launches"] = serving["launches"].get(rec["name"],
                                                               0)
        rec["online_e2e_launches"] = online["launches"].get(rec["name"], 0)
        rec["health_launches"] = health["launches"].get(rec["name"], 0)
        rec["text_launches"] = text["launches"].get(rec["name"], 0)
    # the port-only ordered row scatter-add (P3): no TPU kernel; it replaces
    # the JAX package's scatter-adds of wide rows (Word2Vec's embeddings,
    # FM's gradient, LDA's segment_sum), at Word2Vec's `out` scatter
    p3 = {**text["fm"]["p3"], **text["lda"]["p3"], **text["w2v"]["p3"]}
    r = p3["w2v out f32"]
    kernels.append({
        "name": "row_scatter", "route": "cuda", "source": ROW_SRC,
        "replaces": "alink_tpu/operator/common/nlp/word2vec.py:160",
        "port_only": True, "launches": text["launches"]["row_scatter"],
        "max_abs_err": 0.0, "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "plain_where": r["plain_where"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "bitwise": True, "kernel_ms": r["kernel_ms"],
        "device_ms": r["device_ms"], "host_ms": r["host_ms"],
        "shape": "w2v out f32", "shapes": {k: {f: v[f] for f in (
            "kernel_ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "path", "touched_rows")}
            for k, v in p3.items()},
        "phase21_launches": {"fm": text["fm"]["main_path_launches"][
            "row_scatter"], "lda": {m: v["row_scatter"] for m, v in
                                    text["lda"]["launches"].items()},
            "w2v": text["w2v"]["main_path_launches"]["row_scatter"]}})
    # the port-only FM score (P4): the JAX package's strict-order scan_sum
    # FM serving programs, at the top bucket (sparse, f32)
    p4 = text["fm"]["p4"]
    r = p4["sparse f32 512"]
    kernels.append({
        "name": "fm_score", "route": "cuda", "source": FM_SRC,
        "replaces": "alink_tpu/operator/batch/classification/fm_ops.py:284",
        "port_only": True, "launches": text["launches"]["fm_score"],
        "max_abs_err": 0.0, "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "bitwise": True, "kernel_ms": r["kernel_ms"],
        "device_ms": r["device_ms"], "host_ms": r["host_ms"],
        "shape": "sparse f32 512 x 40", "shapes": {k: {f: v[f] for f in (
            "kernel_ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by")} for k, v in p4.items()}})
    print(json.dumps({"main_path": {
        "text": text,
        "online_e2e": online, "health": health,
        "serving_tier": serving, "als": als, "durability": durability, "linear_family": family,
        "ingest": ingest, "ftrl_batch": batch,
        "ftrl_example": example, "lbfgs": lbfgs, "lr_main": lr_main,
        "gbdt": gbdt, "tree_serving": tree_serving,
        "ftrl": ftrl, "out_of_range_indices": bad_slots,
        "card": card, "sparse_rows_per_s": N_REQUESTS / secs,
        "dense_rows_per_s": N_REQUESTS / dsecs,
        "server_requests": N_SINGLE, "server_launches": server_launches,
        "sparse_buckets": sparse_buckets, "dense_buckets": dense_buckets,
        "sparse_dispatch_ms": sparse_split,
        "dense_dispatch_ms": dense_split}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
