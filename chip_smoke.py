#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``colearn_federated_learning_tpu_torch/csrc``;
   print each head-dim-64 kernel's registers, spills and blocks per SM,
   and fail if any instantiation spills;
3. each flash-attention kernel (K1 forward, K2 dQ, K3 dK/dV) against its
   plain PyTorch version in bf16 — at the BERT-base training shapes and
   the evaluation batch of 64 with a realistic padding mask, a ragged
   L=100, a causal case and a case with a fully masked row — then its
   device time at the training shapes (and K1's at the evaluation batch)
   beside the plain version's, its bound, and torch's SDPA as a yardstick;
   the same at ViT-B/16's shape (16, 50, 12, 64) with no key mask, and
   K1's at ViT's evaluation batch (64, 50, 12, 64).
   Device time is that of calls captured in a CUDA graph and replayed back
   to back, over input sets that together exceed twice the 50 MB L2 cache,
   so each call reads its inputs from HBM as the bound assumes; the host
   loop of wrapper calls on one warm set is reported beside it as
   ``wrapper_ms``, and the graph's own cost per call as its floor;
4. a small-input check (flash vs dense cores of a small BERT on the card),
   then the BERT path: ``FederatedLearner`` on ``agnews_bert_fedavg`` with
   ``attn_impl="flash"`` and 4 local steps (full BERT-base width and
   depth, cohort 10, batch 16, seq 128, bf16) for 2 rounds and an
   evaluation, with the kernels' launch counts read around it;
5. this slice's path: ``cifar10_cnn_fedavg`` (BASELINE config #2) as it
   is — the width-64 CNN in bf16, 100 Dirichlet clients, cohort 20,
   batch 32, its own 34-step budget — for 2 rounds and an evaluation;
6. one round and one evaluation of each other family at full width, each
   cut listed in its line: config #1 (MLP), config #3 (ResNet-18,
   FedProx, cohort cut to 5), ``iot_traffic_tcn_fedavg`` (TCN, cohort cut
   to 5; then ``evaluate_detection(benign_class=0)``, the IoT
   deployment's report: finite, over the whole test set, its accuracy
   the evaluation's), config #5 (ViT-B/16 with
   ``attn_impl="flash"``, cohort cut to 16, 6 of its 12 blocks) and
   MoE-BERT (BERT-base width, 6 blocks, 4 experts, flash, cohort 4, 2
   local steps).  Every path resets the
   launch counts before it and checks them after: depth × (steps +
   evaluation batches) for K1 and depth × steps for K2 and K3 on a flash
   path, none elsewhere;
7. the federated round's other branches through the port's command line
   (``cli.main``) at full width (config #2's cohort cut to 10): 7a
   SCAFFOLD on config #2 (1 round; the
   server variate moves and exactly the contributors' variate rows
   change), 7b FedNova on config #2 with stragglers (the clients' step
   counts, and so their a_i, differ), 7c DP with adaptive clipping and
   secure aggregation on BERT-base (2 rounds; the clip moves, ε equals
   the JAX accountant's value for 7c's q, z and δ, which a CPU test ties
   to JAX; no update norm in the record) and 7c' its round
   0 without the masks (the params agree to 1e-5: the masks cancel on the
   card), 7d Krum on BERT-base at 6 blocks (8 of 10 kept), 7e ring masks
   of degree 4
   with DP on config #2 — each with exact launch counts, its seconds per
   round, evaluation seconds and peak memory;
8. the hierarchical and clustered learners and per-client evaluation at
   full width: 8a ``train --edge-groups 2 --edge-sync-period 2 --rounds
   3`` on BERT-base at 6 of its 12 blocks through ``cli.main`` (2 groups
   of 25 clients, cohort
   10 each; after every sync each group holds the cloud model bit for
   bit, the cloud model is the float64 example-weighted mean of the
   groups' to 1e-6 of its largest entry, the groups part after round 0,
   and the launches are exact over the groups' rounds and the two cloud
   evaluations); 8b ``ClusteredLearner`` on config #2 (cohort cut to 10)
   with a second concept planted on clients 50-99 (y -> 9 - y): 1
   warm-up round, the
   (100, 100) update similarity after 3 steps (symmetric to 1e-5, unit
   diagonal to 1e-4), k-means into two clusters that partition the
   clients, one round of each cluster and their per-client report (the
   labels' agreement with the planted concept is printed, not gated);
   8c ``train --per-client-eval --personalize-steps 5 --detection-eval``
   on BERT-base (full width, 6 of its 12 blocks) for one round: the three
   reports
   finite, the personalized one over all 50 clients, their seconds
   printed, and K1-K3's launches exact with the per-client chunks, the
   250 fine-tune steps (K1-K3), the global and personalized scoring
   chunks of every holdout half and the confusion scan's test batches
   (K1);
9. the server's fold kernel (B4, ``csrc/fold.cu``) and the file plane:
   9a the kernel against its plain version BIT FOR BIT (int32 views) at
   BERT-base's slot layout (198 slots, 108.6 M float32 entries): 10
   topk8 and 10 topk contributions at 5 % density drawn from a seed
   (int64 indices, staged as int32), folded from zeros, onto an
   accumulator and through the overlapped ``fold_sparse`` call, one
   contribution alone, 10 dense contributions, and a -0.0 that must
   survive; then, for topk8 and topk, its device time per launch
   (CUDA-graph replay), the copy of one contribution's staged bytes, the
   plain version's, ``index_add_``'s (the yardstick the port never calls)
   and the bytes bound (the staged tensors' bytes from their element
   sizes, and the 32-byte sectors a scatter touches), and the overlapped
   call per contribution: the host's pack, the copy's and the kernel's
   spans and the whole call by the host clock to a sync; ``fold_dense``
   of the root's 2 partials beside ``torch.sum``; 9b
   ``init``, 2 silos of ``train --role client --compress topk8``,
   ``aggregate`` and ``eval`` on BERT-base at 6 of its 12 blocks (flash,
   4 local steps)
   through ``cli.main``, then the 3 update files through
   ``StreamingFolder(device_fold=True)``, flat and as a two-aggregator
   tree, each bitwise equal to its host fold, the mean within 1e-6 of
   ``aggregate``'s mean delta and the new global model the old plus it,
   with K1-K3's and the fold's launches exact; 9c ``bench`` with its
   defaults, its JSON line printed;
10. remat, the client mesh and the SP/TP options on one card: 10a one
   round of config #4 (BERT-base, flash, 4 local steps) and of ViT-B/16
   (cohort 8), each at 6 of its 12 blocks, without and with ``remat`` on
   the same plan, the
   losses and params equal (bound 1e-4 rel / 2e-5 abs; expected 0.0),
   both peak GiB and each round's seconds printed (the second is warm),
   K1's launches exact under remat (one more per block and step: the
   recomputed forward); 10b the client-mesh round at
   world size 1 on NCCL (``init_device_mesh("cuda", (1,), ("clients",))`` from
   a FileStore): config #4 at 6 of BERT-base's 12 blocks with 4 clients in full
   participation and 4 steps, plain FedAvg, DP with secure aggregation,
   and Krum, each equal to the single-device learner's round on the same
   plan (2e-5), with exactly its path's collectives and exact launches;
   10c ``train --attn-impl ring`` on one card runs the dense core and
   gives the dense run's loss, and ``train --tp-size 2`` warns and gives
   the untiled run's loss (BERT-base at 6 of its 12 blocks);
11. the synchronous socket plane (``comm/``) on the card: 11a a broker, a
   ``FederatedCoordinator`` and 4 ``DeviceWorker``s as threads (3
   trainers and the evaluator) on config #4 (BERT-base at 6 of its 12
   blocks, flash, 4 local steps) with topk8 uplinks, error feedback and
   ``fold_device``, 2 rounds
   and an evaluation, with a trace and a health ledger (13b's checks run
   on this federation): every record complete with a finite loss, the
   params moved, round 0's updates folded again on the host bitwise equal
   to the device fold, K1-K3's launches exact (depth x steps x trainers
   per round, plus the evaluator's batches for K1) and ``fold_sparse``
   once per contribution; the seconds per round, every ``phase_*_s``, the
   fold's device us and the staging copy's per contribution, and
   ``bytes_saved_uplink`` are printed; 11b DH secure aggregation with
   dropout recovery (BERT-base at 6 of its 12 blocks), 4 trainers, 1
   round, a FaultPlan losing trainer 2's
   train reply after the share phase: 3 complete, ``unmask_failed``
   false, the recovered aggregate equal to the survivors' unmasked sum to
   1e-5 absolute (a masked entry is of order 1, so f32 leaves ~1e-6
   after cancellation whatever the update's size), and the same sum with
   one survivor's delta lost or doubled failing that bound; 11c ``cli
   coordinate --fold-device`` (config #2's CNN, num_clients 3; through
   ``cli.main`` in this process, which counts the fold's launches)
   against the CNN fleet (``CliFleet``: ``cli broker`` and 3 ``cli
   worker`` processes, started with phase 11 and shared with 12c, 14c
   and 16b),
   the fleet still running after it, the last record complete with a
   finite loss, ``fold_dense`` launched once per round; with
   ``--learn-observe --metrics-port 0 --events-file``
   (``ObservedCoordinator``): JAX's ``conv_*`` keys on every record with
   the norm of the coordinator's own mean update, ``top --once --url``
   against the live exporter exiting 0 with the round count and the
   learning section, ``/metrics`` parsing as Prometheus text with
   ``learn_update_norm``, the events file's start, round and stop lines,
   and ``converge`` over it exiting 0;
12. the aggregator tree and per-type federation (``comm/aggregator.py``,
   ``comm/per_type.py``) on the card: 12a a broker, 4 trainer threads
   (config #4, BERT-base at 6 of its 12 blocks, flash, 4 local steps,
   topk8 uplinks with error
   feedback), 2 ``AggregatorServer`` threads and the coordinator
   (``num_aggregators`` 2, heartbeat timeout 2 s, no evaluator), every
   fold on the card, with a trace and health ledgers (13c's checks run
   on its round 0), 2 rounds with aggregator 0 stopped after round 0:
   each aggregator's partial bitwise its host fold, the root's sum
   bitwise the host's slice-blocked fold of the round's contributions
   (round 1's re-homed slice included), every record complete with 2
   aggregators and round 1 with a failover, launches exact (K1-K3 6 x 4
   trainers x 4 steps x 2 rounds, ``fold_sparse`` once per contribution,
   ``fold_dense`` once per round on the root); 12b DH secure aggregation
   through the tree (BERT-base at 6 of its 12 blocks), 4 trainers in 2
   slices, trainer 3's train reply lost after the share phase: 3
   complete, each slice recovers on its own
   (only slice 1 rebuilds a lost member's pair masks), the recovered sum
   within 1e-5 of the survivors' unmasked sum and the same sum with one
   survivor's delta lost or doubled failing that bound; 12c 2 x ``cli
   aggregator --fold-device`` join the CNN fleet and ``cli coordinate
   --num-aggregators 2 --fold-device`` runs against it (config #2's CNN,
   3 clients, 1 round), the fleet still running and the root's
   ``fold_dense`` launched once; 12d ``PerTypeFederation`` on
   ``iot_traffic_tcn_fedavg`` (TCN width 64, depth 4, bf16) with 5 worker
   threads announcing MUD profiles (camera, camera, bulb, bulb,
   thermostat), 2 rounds with the device fold: the camera and bulb
   federations run on their own devices, the thermostat is skipped, no
   type fails, the two models are finite, moved and distinct, and
   ``fold_dense`` launches 4 times;
13. the telemetry core (``telemetry/``, ``metrics.py``) on config #4:
   13a ``train`` through ``cli.main`` (BERT-base at 6 of its 12 blocks
   since PR 23) for 2 rounds without and with
   ``--trace-dir --trace-rounds 1 --log-file --tensorboard-dir
   --profile-dir`` on the same plan: the same record keys but the traced
   records' ``flops_per_round``, which equals the hand count of that
   BERT at 4 steps × 16 × cohort 10 (``bert_step_flops``), one Chrome trace
   of the profiler window (round 1 alone) whose card events hold K1-K3
   by name, once per block and step of round 1 (K1 with its evaluation
   batches), the losses and params within 10a's
   bound (expected 0.0), the trace's ``round``/``client_update``/
   ``sync_metrics`` spans of round 0 only, ``client_update`` equal to
   each record's ``phase_update_s``, the JSONL lines the records, the
   ``trace-summary`` text and both runs' seconds per round printed, and
   K1-K3's launches exact; 13b on 11a's federation (run in phase 11 with
   a trace and a health ledger, 2 rounds and an evaluation): each
   trainer's adopted
   ``worker.train`` (with ``local_train`` and ``compress_delta`` inside)
   lies in ``broadcast_collect``, the ledger holds the 3 trainers, the
   records carry the ``health_*`` keys, ``fed.rounds_total`` is 2 and the
   frames sent equal the frames received; the collect's split per round
   (the slowest trainer's ``deserialize_params``, ``local_train`` and
   ``compress_delta``, and the rest) is printed; launches as 11a's; 13c
   on 12a's federation (run in phase 12 with a trace and ledgers), its
   round 0: the tier's
   ``aggregator.fold`` spans parent onto the root's round and the
   trainers' spans onto them, the ledgers hold the 4 trainers with their
   aggregator, ranked by latency ``assign_slices`` puts the slowest in
   the last slice, ``fold_sparse`` 4 and ``fold_dense`` 1 launch as in a
   12a round; the tier's fold seconds against the collect are printed;
14. the asynchronous coordinator (``comm/async_coordinator.py`` and the
   aggregators' buffered ops) on the card: 14a a broker, 4 trainer threads
   and the evaluator, and ``AsyncFederatedCoordinator(buffer_size=2,
   observe=True)`` with a trace and a health ledger on config #4 (6 of
   its 12 blocks, flash, 4 local steps, topk8 uplinks with error
   feedback, the device fold), 4 aggregations and an evaluation: JAX's
   record keys with the observe and ``health_*`` keys, versions 1-4, 2
   contributors each, staleness within ``max_staleness``, a finite loss and moved params, aggregation 0's
   staged contributions folded again on the host bitwise equal to the
   device fold, every ``fold_update`` span parented on its
   ``dispatch_train``, and exact launches (``fold_sparse`` once per folded
   update, K1-K3 depth x steps per dispatch from the ``dispatch_train``
   spans plus the evaluator's K1 batches); per aggregation its seconds,
   the collect and apply phases, the staleness mean, max and p90, the
   arrival rate and the discards, and the aggregations per second over
   aggregations 1-3 are printed; 14b the same config through 2
   ``AggregatorServer`` threads with the device fold (``num_aggregators``
   2, ``agg_buffer_interval_s`` 2, heartbeat timeout 2 s, 4 trainers, no
   evaluator), 4 aggregations, aggregator 0 stopping as the first
   contribution after aggregation 1 reaches it: every drained partial
   bitwise the host fold of its keys, every dispatched contribution
   drained at most once or still in flight, a record with the failover,
   launches exact (``fold_sparse`` once per contribution in a drained
   partial, ``fold_dense`` once per applied partial on the root); 14c
   ``cli coordinate --async-buffer 3 --fold-device --no-evaluator``
   against the CNN fleet on 11c's config (K = 3 = trainers, so each
   aggregation is a full round): the fleet still runs after it,
   ``fold_dense`` launches once per aggregation, each aggregation's
   ``total_weight`` equals 11c's round's, and aggregation 0's
   ``train_loss``, mean update and global params after the step equal
   11c's round 0 within f32 rtol 1e-4 / atol 2e-5 (aggregation 1's too
   when the two round-0 folds are bitwise equal: the fold order differs);
   observed as 11c is (``ObservedCoordinator``);
15. LoRA adapter federation (``fed/lora.py``, rank 8, alpha 16, a merge
   every 2 aggregations) on the card, BERT-base at 6 of its 12 blocks: 15a
   11a's federation (3 trainers and the evaluator, config #4, the device
   fold) with dense factor uplinks, 3 rounds and an evaluation: every
   update is the factor tree (74 leaves, 913,872 float32), ``bytes_saved_uplink`` is the dense frame's length
   less the factor frame's per update (JAX's pricing), every round's
   ``fold_dense`` of the 3 factor updates bitwise its host fold, round 0
   leaves the base bit for bit and moves the factors, ``lora_merged``
   reads [False, True, False], round 1's base within f32 rtol 1e-4 / atol
   2e-5 of ``merge_adapters`` on the host with B zero and A kept, the
   evaluation scores the temporary merge and leaves the base bit for bit,
   launches exact; the merge's seconds against its bytes bound and the
   trainer's seconds per local step are printed; 15b 12a's tree (4
   trainers, 2 aggregators with the device fold) with topk8 factor
   uplinks and error feedback, 2 rounds, no failover: every slice's
   ``fold_sparse`` bitwise its host fold, the root's ``fold_dense`` of the
   2 factor partials bitwise the slice-blocked host fold, the ``lora``
   marker on every trainer's frame through the tier, launches exact; 15c
   11b's DH secure round over the factors (trainer 2's reply lost): the
   recovered aggregate within 1e-5 of the survivors' unmasked factor sum
   (``check_recovery``); 15d a fleet of its own (``cli broker``, 3 x
   ``cli worker --lora-rank 4``) and ``cli coordinate --lora-rank 4
   --lora-merge-every 2 --fold-device --no-evaluator`` on config #2's
   CNN, 2 rounds: every process exits 0, every round complete, the updates adapt exactly the
   Conv (HWIO) and Dense kernels, ``lora_merged`` reads [False, True]
   (the loss is printed: config #2's SGD diverges under the adapters'
   alpha/r = 4, JAX's trainer too); then the fold kernel at
   BERT-base's full-depth factor layout (146 slots; ``fold_dense`` of 3
   contributions and of 2
   partials, ``fold_sparse`` of topk8 contributions) bitwise its plain
   version and timed as in 9a;
16. checkpoints and resume (``ckpt/``) on the card: 16a ``train`` on
   config #4 (BERT-base at 6 of its 12 blocks, flash, 4 local steps) for
   1 round with
   ``--checkpoint-dir``, then ``--rounds 2 --resume``: stderr says
   ``resumed at round 1``, K1-K3 launch exactly, and the step-2
   checkpoint, read leaf by leaf, equals that of 13a's untraced run
   (which saves its last round) bit for bit; 16b ``coordinate
   --checkpoint-dir --checkpoint-every 1 --ckpt-stream`` as a process
   against the CNN fleet, SIGKILLed as soon as round 0's record line is
   out, then ``coordinate --resume`` through ``cli.main`` against the
   live fleet: the ``resumed`` event at round 1 with no generation
   discarded and generation 1's ``load_generation_host`` digest,
   ``challenge_verified`` with the 3 workers and no rejection, 2 WAL
   entries, round 1 through ``fold_dense`` once, its params bitwise
   11c's round 1 when the killed run's round-0 state is 11c's and the
   round-1 fold orders agree (else the difference is printed), and the
   fleet stopped with SIGTERM, its 6 processes exiting 0; 16c 11a's
   and 14a's federations save their live state as streaming generations
   after their rounds (BERT-base width), and a fresh coordinator of each
   kind restores it: params bitwise the live ones, the version (14a) and
   ``round_idx`` equal, ``last_restore_digest`` equal to
   ``load_generation_host``'s; ``ckpt.save_s`` and ``ckpt.restore_s``
   with their MB and MB/s, the shard count and the CRC pass's share of
   the save are printed;
17. the chaos soaks on the card: 17a ``chaos --mp --rounds 6
   --num-workers 3`` through ``cli.main`` (the broker, 3 workers and the
   coordinator as processes of the port's command line on config #1's
   MLP; worker 1 SIGKILLed after round 1 and respawned, the coordinator
   after round 2 and resumed with ``--resume``, the broker after round 3
   and respawned on its port): the command's gate passes, two
   coordinator incarnations, a parseable flight dump of each of the 8
   processes, and every child but the broker on the card (``--backend
   gpu`` and a ``cuda`` device event in its dump); 17b ``postmortem
   --format json`` over them names the killed coordinator's pid and role,
   and its committed rounds are the WAL's; 17c ``chaos --tree-async
   --lock-witness --rounds 6 --num-workers 3`` through ``cli.main`` (two
   fleets of a broker, 3 workers, 2 aggregators and the asynchronous
   coordinator at K = 2, every process under the lock witness; in the
   faulted one aggregator 0 SIGKILLed after aggregation 2 and left dead,
   the broker after aggregation 4 and respawned on its port): the
   command's gate passes, the failover fired with no double fold and
   every re-homed device in the ledger, the killed aggregator's dump
   names it, the witness reports saw lock traffic with no inversion and
   no unguarded access, and every child but the brokers on the card;
   the witness's counts, the failovers, the loss tails, the time to
   recover from each kill and the seconds are printed;
18. the sharded server (``parallel/partition.py``'s ``ServerPlacement``)
   on the card: 18a BERT-base's server params (9a's layout) over a
   ``(model,)`` placement of 2 positions on the one card, 9a's 10 topk8
   and 10 dense contributions and 2 partials through
   ``StreamingFolder(placement=..., device_fold=True)``: ``fold_sparse``
   and ``fold_dense`` at the per-shard slot layout (319 slots) bitwise
   their plain versions there, the assembled mean bitwise the replicated
   device fold's and the host fold's, one FedAdam ``server_update`` over
   the shards (params and both moments) bitwise the replicated step, the
   downlink frame byte-equal to the replicated one with
   ``comm.gather_bytes_avoided_total`` moved by exactly
   ``tree_gather_avoided``, ``bytes_per_chip`` printed, and each kernel
   timed at that layout beside its plain version, its library call and
   its bound; 18b ``make_server_placement`` falls back on the one card
   (``insufficient_devices``) and for config #1's MLP at tp = 3
   (``rules_matched_nothing``), each counted; 18c ``chaos --ckpt``
   through ``cli.main`` (JAX's defaults: a tp = 2 ``--ckpt-stream``
   coordinator on the CPU, its broker and 2 workers on the card,
   SIGKILLed mid-save and resumed at tp = 1, against a kill-free oracle):
   the command's gate passes with ``resharded`` >= 1; the kill's
   generation, the committed step, the seconds from the kill to the
   resumed round's record and the soak's seconds are printed;
19. checkpoints of a learner on a client mesh (on a thread beside 17a
   and 17b, whose soak is processes the script waits on, and joined
   before 17c starts, so 17c's recoveries are read alone): config #2 with
   ``--strategy scaffold --momentum 0`` at cohort 10 (7a's cut) on a
   world-1 NCCL mesh: an uninterrupted 2-round run, a run that saves
   after round 0, and a fresh mesh learner that restores the step and
   runs round 1: its params, server control and every variate row bitwise
   the uninterrupted run's, the step's leaves the one-device learner's
   paths and shapes; the save and restore seconds and the step's MB are
   printed;
20. the fleet simulator (``fleetsim/``): 20a ``fleetsim --devices
   1000000 --cohort 1024 --chunk 256 --rounds 3 --compress topk8``
   through ``cli.main`` with ``--trace-dir`` and a fault plan of
   ``drop_request``, ``delay`` (the whole deadline) and
   ``corrupt_payload`` (each ``count`` 0, 2 %): every round's cohort,
   firings, trained and completed devices equal the host's replay of the
   plan on the traffic model's cohorts, ``fault.injected_total`` moves by
   the firings, the byte estimates are the shape-only frame prices times
   the devices, the loss is finite and the trace holds one
   ``train_chunk`` span per chunk; the seconds per round and the clients
   per second are printed; then its first 2 rounds with
   ``--learn-observe``: every record carries the observatory's keys with
   ``conv_cohort_skew`` and ``conv_norm_p90``, and is otherwise 20a's bit
   for bit, its seconds per round printed beside 20a's; 20b ``FleetSim.from_learner`` on config #1
   (MLP, f32): the one-chunk round bitwise the engine's ``run_round``
   from the same state and draws, the 4-chunk round within 1e-5 of the
   round's largest update entry; 20c
   ``fleetsim --async-buffer auto --async-observe`` and
   ``--async-buffer 8 --aggregators 2`` for 6 aggregations at the
   command's default 10,000 devices, each returning with
   ``model_version`` 6; ``arrival_tracking``, ``staleness_p90`` (the
   registry reset before each command, so each its own run's) and the
   tree's ``agg_fold_tracking_min`` are printed;
21. the analysis tools (``analysis/``): 21a ``lint --gate --format
   json`` over the port's package through ``cli.main``: 0 findings, 0
   baselined (its files, suppressed count and seconds printed); 21b the
   learn smoke (the JAX package's ``scripts/learn_smoke.py``
   configuration) through the port's ``FleetSim`` on the card: 64
   devices, a 32-wide MLP of depth 1, cohort and chunk 16, 2 local steps
   of batch 8 at lr 0.05, 12 observed rounds from seed 0, written as
   ``results/learn_events.jsonl`` rows under a temporary root holding
   the repo's ``pyproject.toml``: the three sentinels over those rows
   (``live-learn-*`` and ``fleet-learn-cohort-skew-ceiling``) are ok
   and ``live-learn-divergence`` and ``live-learn-plateau`` are judged
   (12 rows of the 11 they need, a value); the same seed with a 10x lr
   spike at round 9, read at rounds 0-11, trips ``live-learn-divergence``
   with ``above_max_ratio``, and its round 8 update norm is the clean
   run's to 6 decimals; 21c ``fleetsim --async-buffer 32
   --async-observe`` for 30 aggregations at 10,000 devices (K 32,
   ``fit_async``'s own default: under ``auto`` K grows to 1,024 and the
   30 aggregations train some 20,000 clients), its records
   written as ``results/async_events_port.jsonl`` rows under such a
   root: ``live-async-staleness-tail-drift`` reads at least 25 rows and
   is ok, and ``live-async-arrival-rate-floor``'s verdict is printed (it
   reads ``arrival_rate_per_s``, which only the coordinator writes);
   21d ``sentinel --root <repo> --format json`` through ``cli.main``:
   ``ok``, 32 rules, 0 violations;
22. the measurement drivers (``scripts/torch_port_*.py``), each through
   its ``main`` on the card, writing into a temporary root that holds the
   repo's ``pyproject.toml``: 22a ``perf_north_star`` at its full shape
   (1000 clients of 64 CIFAR-10 examples, cohort 64, 8 steps of 32, the
   width-64 bf16 CNN) cut to ``--rounds 3 --warmup 1``, its summary
   printed (rounds/sec, client-samples/sec, peak GiB, the model-FLOPs
   utilization against the card's bf16 peak); 22b ``bench_fleet
   --cohorts 1000`` with every sweep flag at its defaults and
   ``--check-schema``; 22c ``bench_wire --check-schema`` with its sweep
   cut to 2 rounds, cohort 4, 1 timed fold per fold row and 1 timed save
   per checkpoint row (every device ``wire_fold`` row bitwise the host
   fold; ``fold_sparse`` and ``fold_dense`` launched), then ``--fold-device
   --cohorts 4 --schemes topk8`` rounds, whose
   ``fold_device_folds_per_round`` must equal the cohort; 22d
   ``mesh_smoke`` at its defaults (4 positions repeating the card); 22e
   ``sentinel --root <root> --format json`` through ``cli.main`` over
   those rows: every rule's id, value and verdict printed, and every rule
   ok but ``fleet-1m-round-rate`` and ``fleet-1m-client-throughput``
   (no 1M ``fleet_round`` row is written: printed with the clients/s at
   cohort 1,000 and the round time it implies for a cohort of 1,000,000);
23. the last drivers: 23a ``dryrun.entry()``'s ViT-B/16 forward on the
   card (bf16, K1 at L = 50, exactly one launch per block and call) on
   its zero batch and a seeded one against the same parameters through
   the plain (dense) core, held as phase 3 holds a kernel, with the f32
   truth beside it; ``dryrun_multichip(1)`` on a world-1 NCCL group made
   here (the CNN round with DP and secure aggregation), and
   ``scripts/torch_port_record_dryrun.py 1`` (a process, which spawns
   its own rank) writing its row; 23b ``cli bench --rounds 5 --warmup 1
   --skip-baseline`` under ``torchrun --standalone --nproc-per-node 1``
   (9c runs 20 rounds after 2 and the baseline): ``n_devices`` 1, its rounds/sec
   printed beside 9c's; 23c ``torch_port_run_baseline_configs.py
   --attn-impl flash`` (the text and ViT variants through K1-K3):
   ``agnews_bert_fedavg`` to its 20 rounds in this process (its K1-K3
   launches counted), and in processes beside it (``VARIANT_GROUPS``)
   ``mnist_mlp_fedavg`` (20 rounds) and ``iot_traffic_tcn_fedavg`` (25)
   to their rounds and every other variant for 1 round at its own width
   (``femnist_vit_full3400``'s cohort cut to 64): every loss finite,
   mnist's and the TCN's last accuracy at least 0.95,
   ``agnews_bert_fedavg``'s rise from round 0 to round 19 at least half
   of the JAX package's committed curve's
   (``results/agnews_bert_fedavg.jsonl``), both curves printed; 23a's
   record, 23d ``torch_port_chaos_soak.py``'s gate (a process on the
   card), 23e ``torch_port_chaos_soak_mp.py``'s gate (processes on the
   card) and 23f ``torch_port_obs_smoke.py``'s four phases (workers and
   coordinators on the card; ``OBS_GROUPS``, two processes), each on a
   thread of its own from 23c on; then 23d's ``torch_port_trace_smoke.py``
   alone (coverage at least 0.95).

Each phase prints its wall seconds on a line of its own; then one line
gives the script's seconds, every phase's and the bench's (9c) rounds per
second, and the last two lines are one JSON line of per-kernel results
(launches summed over the paths) and the result line.

Every synthetic dataset is drawn once in the process and copied to each
later caller (``cache_synthetic_data``): a draw is a function of the
dataset and the seed, and CIFAR-10's takes seconds on the host.

Needs a CUDA device and the repository beside it; it exits non-zero and
prints no result otherwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
L2_BYTES = 50e6                # H100 L2 cache
BF16_TOL = 2e-2                # kernel vs plain, of the largest |plain|
BF16_ULP = 2.0 ** -8           # one bf16 step at the largest magnitude
KERNELS = {
    "flash_forward": ("colearn_federated_learning_tpu/ops/attention.py:85",
                      4),
    "flash_backward_dq": (
        "colearn_federated_learning_tpu/ops/attention.py:215", 6),
    "flash_backward_dkv": (
        "colearn_federated_learning_tpu/ops/attention.py:259", 8),
}
SOURCE = "colearn_federated_learning_tpu_torch/csrc/flash_attention_kernels.cuh"
VIT_L = 50                     # ViT-B/16 on 28 x 28 FEMNIST: 7 x 7 patches + cls


def log(*args):
    """A line of the script's record on the process's own stdout: a
    thread beside a phase (19 beside 17a and 17b) logs there even while
    that phase captures ``sys.stdout`` to read a command's output."""
    print(*args, file=sys.__stdout__, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def fresh_peak() -> None:
    """Free what earlier paths left unreachable (a learner held only in a
    reference cycle, such as a wrapped method, waits for the collector)
    and restart the peak-memory count, so a path's peak is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def time_ms(fn, iters: int = 50) -> float:
    """Mean time of ``fn`` over ``iters`` calls in a host loop, after
    warm-up, by events around the loop: the wrapper's host cost where it
    exceeds the kernel's, on inputs that stay in L2."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, sets, passes: int = 4, replays: int = 5) -> float:
    """Mean device time of one call ``fn(s)``: ``passes`` passes through
    ``sets`` captured in one CUDA graph, whose replays are timed by events,
    so the host's cost of a call is not counted and the card runs the
    calls back to back.  Where the sets together exceed the L2 cache
    (``input_sets``), every call finds its inputs in HBM."""
    for s in sets:
        fn(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # "relaxed": a build that sets a kernel attribute at each launch is
    # still capturable.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(passes):
            for s in sets:
                fn(s)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * passes * len(sets))


def input_sets(A, B, L, H, D, mask, seed):
    """Input sets of the kernels at one shape, enough of them that together
    they exceed twice the L2 cache: q, k, v, dO and the key bias, the lse
    and Δ of the forward kernel, and SDPA's (B, H, L, D) copies."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    n = max(5, math.ceil(2 * L2_BYTES / bound_bytes("flash_forward",
                                                     B, L, H, D)))
    sets = []
    for _ in range(n):
        q, k, v, dout = (torch.randn(B, L, H, D, generator=g)
                         .to(torch.bfloat16).to(dev) for _ in range(4))
        bias = A.key_bias(mask.to(dev), B, L, dev)
        o, lse = A.flash_forward(q, k, v, bias)
        delta = (dout.float() * o.float()).sum(-1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sets.append(SimpleNamespace(
            q=q, k=k, v=v, dout=dout, bias=bias, lse=lse, delta=delta,
            qt=qt, kt=kt, vt=vt,
            amask=None if mask.all() else mask.to(dev)[:, None, None, :]))
    return sets


def padding_mask(B: int, L: int, seed: int) -> torch.Tensor:
    """Token-id padding of the synthetic AG-News corpus (id 0 = pad)."""
    from colearn_federated_learning_tpu_torch.data import synthetic

    ids, _ = synthetic.synthetic_text_classification(B, L, 30522, 4, seed=seed)
    return torch.from_numpy(ids != 0)


def check_close(what, got, ref, truth):
    """Hold a bf16 kernel output to its bf16 plain version ``ref`` and to
    the f32 ``truth``: the kernel must lie within BF16_TOL of ``ref``
    (scaled by its largest magnitude), and its error against ``truth`` must
    stay within twice the plain version's error plus one bf16 step at the
    largest magnitude.  Returns the max abs error against ``ref``."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    top = float(truth.abs().max())
    err = float((got - ref).abs().max())
    bound = BF16_TOL * float(ref.abs().max())
    err_truth = float((got - truth).abs().max())
    bound_truth = 2.0 * float((ref - truth).abs().max()) + BF16_ULP * top
    if err > bound or err_truth > bound_truth:
        raise AssertionError(
            f"{what}: max abs err {err} (bound {bound}), against f32 "
            f"{err_truth} (bound {bound_truth})")
    return err


def kernel_case(A, name, B, L, H, D, causal, mask, seed):
    """Run K1-K3 and their plain versions on one input; return the max abs
    error of each kernel against its plain version after checking it."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=g)
                     .to(torch.bfloat16).to(dev) for _ in range(4))
    bias = A.key_bias(mask.to(dev), B, L, dev)
    o_ref, lse_ref = A.flash_forward_reference(q, k, v, bias, causal)
    o, lse = A.flash_forward(q, k, v, bias, causal)
    delta = (dout.float() * o_ref.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, bias, dout, lse_ref, delta, causal)
    dq_ref = A.flash_backward_dq_reference(q, k, v, bias, dout, lse_ref,
                                           delta, causal)
    dk, dv = A.flash_backward_dkv(q, k, v, bias, dout, lse_ref, delta, causal)
    dk_ref, dv_ref = A.flash_backward_dkv_reference(q, k, v, bias, dout,
                                                    lse_ref, delta, causal)
    # The same functions on the same values in f32, rounding nowhere.
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    o_f32, _ = A.flash_forward_reference(qf, kf, vf, bias, causal)
    dq_f32 = A.flash_backward_dq_reference(qf, kf, vf, bias, dof, lse_ref,
                                           delta, causal)
    dk_f32, dv_f32 = A.flash_backward_dkv_reference(qf, kf, vf, bias, dof,
                                                    lse_ref, delta, causal)
    torch.cuda.synchronize()
    if not torch.equal(lse >= 1e29, lse_ref >= 1e29):
        raise AssertionError(f"{name}: fully masked rows differ")
    fin = lse_ref < 1e29
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    if lse_err > 1e-3:
        raise AssertionError(f"{name}: lse max abs err {lse_err}")
    errs = {
        "flash_forward": check_close(f"{name}/O", o, o_ref, o_f32),
        "flash_backward_dq": check_close(f"{name}/dQ", dq, dq_ref, dq_f32),
        "flash_backward_dkv": max(
            check_close(f"{name}/dK", dk, dk_ref, dk_f32),
            check_close(f"{name}/dV", dv, dv_ref, dv_f32)),
    }
    if not bool(mask.any(dim=1).all()):
        rows = ~mask.any(dim=1)
        if float(o[rows.to(dev)].float().abs().max()) != 0.0:
            raise AssertionError(f"{name}: fully masked rows are not 0")
    log(f"  case {name:10s} B={B} L={L} H={H} D={D} causal={causal}: "
        + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
        + f", lse err {lse_err:.2e} (bounds: {BF16_TOL} x max|plain|; "
        f"2 x plain's err + {BF16_ULP} x max|f32| against f32)")
    return errs


def bound_bytes(kname, B, L, H, D) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    act, bias, rowf = B * L * H * D * 2, B * L * 4, B * L * H * 4
    return {
        "flash_forward": 3 * act + bias + act + rowf,
        "flash_backward_dq": 4 * act + bias + 2 * rowf + act,
        "flash_backward_dkv": 4 * act + bias + 2 * rowf + 2 * act,
    }[kname]


def bound_ms(kname, B, L, H, D) -> tuple[float, str]:
    """Least time for the same work: its bytes over HBM bandwidth, or the
    products at the bf16 peak."""
    flops = KERNELS[kname][1] * B * H * L * L * D
    t_bytes = bound_bytes(kname, B, L, H, D) / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(A):
    from torch.nn import functional as F

    B, L, H, D = 16, 128, 12, 64
    errs = {k: 0.0 for k in KERNELS}
    cases = [
        ("slice", B, L, H, D, False, padding_mask(B, L, 1), 11),
        ("eval", 64, L, H, D, False, padding_mask(64, L, 5), 15),
        ("ragged", B, 100, H, D, False, padding_mask(B, 100, 2), 12),
        ("causal", 4, L, H, D, True, padding_mask(4, L, 3), 13),
    ]
    row_mask = padding_mask(4, L, 4)
    row_mask[1] = False
    cases.append(("masked_row", 4, L, H, D, False, row_mask, 14))
    # ViT-B/16 on FEMNIST: 49 patches + the class token, no key mask, at
    # the training batch and the evaluation batch.
    cases.append(("vit", B, VIT_L, H, D, False,
                  torch.ones(B, VIT_L, dtype=torch.bool), 16))
    cases.append(("vit_eval", 64, VIT_L, H, D, False,
                  torch.ones(64, VIT_L, dtype=torch.bool), 17))
    for case in cases:
        e = kernel_case(A, *case)
        errs = {k: max(errs[k], e[k]) for k in errs}

    rows = time_kernels(A, B, L, H, D, cases[0][6], errs)
    eval_forward(A, "BERT", 64, L, H, D, cases[1][6])
    log(f"  at the ViT shape ({B}, {VIT_L}, {H}, {D}), no key mask:")
    vit = time_kernels(A, B, VIT_L, H, D, cases[-2][6], errs)
    log("  vit shape rows " + json.dumps(vit))
    eval_forward(A, "ViT", 64, VIT_L, H, D, cases[-1][6])
    return rows


def eval_forward(A, label, B, L, H, D, mask):
    """Device time of K1 at an evaluation batch beside its bound and SDPA."""
    from torch.nn import functional as F

    sets = input_sets(A, B, L, H, D, mask, 22)
    bms, bby = bound_ms("flash_forward", B, L, H, D)
    k1 = device_ms(lambda s: A.flash_forward(s.q, s.k, s.v, s.bias), sets)
    sdpa = device_ms(lambda s: F.scaled_dot_product_attention(
        s.qt, s.kt, s.vt, attn_mask=s.amask), sets)
    log(f"  flash_forward at the {label} evaluation batch ({B}, {L}, {H}, "
        f"{D}): {k1 * 1e3:.2f} us device ({bms / k1:.1%} of bound "
        f"{bms * 1e3:.2f} us, {bby}); sdpa {sdpa * 1e3:.2f} us")


def time_kernels(A, B, L, H, D, mask, errs):
    """Device time of K1-K3 at one shape beside their plain versions, the
    bound and SDPA; returns the per-kernel rows."""
    from torch.nn import functional as F

    sets = input_sets(A, B, L, H, D, mask, 21)
    fns = {
        "flash_forward": (
            lambda s: A.flash_forward(s.q, s.k, s.v, s.bias),
            lambda s: A.flash_forward_reference(s.q, s.k, s.v, s.bias),
            lambda s: F.scaled_dot_product_attention(s.qt, s.kt, s.vt,
                                                     attn_mask=s.amask)),
        "flash_backward_dq": (
            lambda s: A.flash_backward_dq(s.q, s.k, s.v, s.bias, s.dout,
                                          s.lse, s.delta),
            lambda s: A.flash_backward_dq_reference(
                s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta), None),
        "flash_backward_dkv": (
            lambda s: A.flash_backward_dkv(s.q, s.k, s.v, s.bias, s.dout,
                                           s.lse, s.delta),
            lambda s: A.flash_backward_dkv_reference(
                s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta), None),
    }
    tiny = torch.zeros(1, device="cuda")
    log(f"  device times over {len(sets)} input sets of "
        f"{bound_bytes('flash_forward', B, L, H, D) / 1e6:.1f}+ MB each; "
        "graph floor per call (one 1-element add) "
        f"{device_ms(lambda s: tiny.add_(1), sets) * 1e3:.2f} us")
    rows = {}
    for kname, (kern, plain, lib) in fns.items():
        bms, bby = bound_ms(kname, B, L, H, D)
        rows[kname] = {
            "ms": device_ms(kern, sets),
            "wrapper_ms": time_ms(lambda: kern(sets[0])),
            "plain_ms": device_ms(plain, sets),
            "library_ms": device_ms(lib, sets) if lib is not None else None,
            "bound_ms": bms, "bound_by": bby, "max_abs_err": errs[kname],
        }
        r = rows[kname]
        warm = device_ms(kern, sets[:1])
        log(f"  {kname:19s} {r['ms'] * 1e3:8.2f} us device "
            f"({bms / r['ms']:.1%} of bound {bms * 1e3:.2f} us, {bby}); "
            f"{warm * 1e3:.2f} us on one set left in L2; "
            f"wrapper loop {r['wrapper_ms'] * 1e3:.2f} us; plain "
            f"{r['plain_ms'] * 1e3:.2f} us; sdpa "
            + (f"{r['library_ms'] * 1e3:.2f} us" if lib is not None
               else "none"))
    # Yardstick only: SDPA's backward computes dQ, dK and dV in one call.
    # It is captured with its forward (autograd runs a backward on its
    # forward's stream), whose time is then taken off.
    for s in sets:
        s.ins = [t.clone().requires_grad_(True) for t in (s.qt, s.kt, s.vt)]
        s.dot = s.dout.transpose(1, 2).contiguous()
    sdpa_fb = device_ms(lambda s: torch.autograd.grad(
        F.scaled_dot_product_attention(*s.ins, attn_mask=s.amask), s.ins,
        s.dot), sets)
    sdpa_bwd = sdpa_fb - rows["flash_forward"]["library_ms"]
    ours = rows["flash_backward_dq"]["ms"] + rows["flash_backward_dkv"]["ms"]
    log(f"  sdpa backward (dQ, dK, dV together): {sdpa_bwd * 1e3:.2f} us "
        f"device; flash_backward_dq + flash_backward_dkv {ours * 1e3:.2f} us")
    return rows


def small_model_check():
    """Flash and dense cores of one small BERT agree on the card."""
    from colearn_federated_learning_tpu_torch.models import registry
    from colearn_federated_learning_tpu_torch.utils import prng
    from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(name="bert", num_classes=4, width=128, depth=2,
                      num_heads=2, seq_len=64, vocab_size=1000,
                      dtype="bfloat16")
    dense = registry.build_model(cfg, "cuda", generator=prng.init_generator(0))
    flash = registry.build_model(dataclasses.replace(cfg, attn_impl="flash"),
                                 "cuda")
    flash.load_state_dict(dense.state_dict())
    ids = torch.randint(1, 1000, (8, 64), generator=torch.Generator()
                        .manual_seed(5))
    ids[:, 40:] = 0
    ids[3] = 0                       # an all-padding example
    ids = ids.cuda()
    with torch.no_grad():
        ld, lf = dense(ids), flash(ids)
    err = float((ld - lf).abs().max())
    bound = 5e-2 * max(1.0, float(ld.abs().max()))
    if not (torch.isfinite(lf).all() and err <= bound):
        raise AssertionError(f"small BERT flash vs dense: {err} > {bound}")
    log(f"  small BERT logits, flash vs dense core: max abs err {err:.3e} "
        f"(bound {bound:.3e})")


def main_path_config():
    """BASELINE config #4 (BERT-base on AG-News, FedAvg) with the flash
    attention core, cut to 4 local steps per client."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    base = get_config("agnews_bert_fedavg")
    return base.replace(
        model=dataclasses.replace(base.model, attn_impl="flash"),
        fed=dataclasses.replace(base.fed, local_steps=4))


BERT: dict = {}              # bert_params' one draw


def bert_params():
    """BERT-base's initial server params (``main_path_config``, the flax
    layout, float32 host arrays), drawn on the card once in the process:
    9a, the factor layout of phase 15 and phase 18 read it (no caller
    writes into it)."""
    if "params" not in BERT:
        from colearn_federated_learning_tpu_torch.fed import setup

        BERT["params"] = setup.init_global_params(main_path_config(), "cuda")
    return BERT["params"]


def main_path(A):
    """The BERT path (``main_path_config``): 2 rounds and an evaluation."""
    return drive_path(A, "bert", main_path_config(), 2, "local_steps 4")


def drive_path(A, label, cfg, rounds, cuts, detection=False):
    """Build ``FederatedLearner(cfg)`` on the card, run ``rounds`` rounds
    and one evaluation, check that the output is finite, that every
    sampled client completed and that the params moved, and that the
    flash kernels launched exactly depth × (steps + evaluation batches)
    (K1) and depth × steps (K2, K3) times on a flash path, and never
    elsewhere; with ``detection``, then ``evaluate_detection()`` (after
    the launch counts are read; ``detection_check``).  Returns the launch
    counts."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    learner = FederatedLearner(cfg)
    n_params = sum(p.numel() for p in learner.params.values())
    width = cfg.model.hidden_dim if cfg.model.name == "mlp" else cfg.model.width
    log(f"  [{label}] {cfg.run.name}: {cfg.model.name} width {width} "
        f"{cfg.model.dtype}, {n_params / 1e6:.2f} M params; "
        f"{learner.num_clients} clients, cohort {learner.cohort_size}, "
        f"{learner.num_steps} steps x batch {cfg.fed.batch_size}; cuts: "
        f"{cuts}; built in {time.perf_counter() - t0:.2f} s")
    before = [p.clone() for p in learner.params.values()]
    fresh_peak()
    A.reset_launches()
    round_s = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = learner.run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"  [{label}] round {rec['round']}: train_loss "
            f"{rec['train_loss']:.6f} completed {rec['completed']:.0f} "
            f"delta_norm_mean {rec['delta_norm_mean']:.6f} "
            f"in {round_s[-1]:.3f} s")
        if not (math.isfinite(rec["train_loss"])
                and math.isfinite(rec["delta_norm_mean"])
                and rec["completed"] == learner.cohort_size):
            raise AssertionError(f"{label}: bad round record {rec}")
    t0 = time.perf_counter()
    eval_loss, eval_acc = learner.evaluate()
    eval_s = time.perf_counter() - t0
    launches = dict(A.launches)
    changed = sum(float((p - b).abs().sum())
                  for p, b in zip(learner.params.values(), before))
    finite = all(bool(torch.isfinite(p).all())
                 for p in learner.params.values())
    log(f"  [{label}] evaluate: loss {eval_loss:.6f} acc {eval_acc:.4f} in "
        f"{eval_s:.3f} s; launches {launches}; params moved (sum |diff|) "
        f"{changed:.6e}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not (finite and math.isfinite(eval_loss) and 0.0 <= eval_acc <= 1.0
            and changed > 0):
        raise AssertionError(f"{label}: output is not finite or did not train")
    if detection:
        detection_check(label, learner, eval_acc)
    flash = cfg.model.attn_impl == "flash"
    steps = rounds * learner.cohort_size * learner.num_steps
    eval_batches = math.ceil(len(learner.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth if flash else 0
    want = {"flash_forward": depth * (steps + eval_batches),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [{label}] seconds per round: {round_s}; path "
        f"{time.perf_counter() - t_path:.2f} s")
    return launches


def detection_check(label, learner, eval_acc) -> None:
    """``evaluate_detection()`` with benign class 0, the IoT deployment's
    report: finite, over the whole test set, its accuracy the
    evaluation's (the confusion matrix counts the same argmax)."""
    t0 = time.perf_counter()
    rep = learner.evaluate_detection(benign_class=0)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    keys = ("accuracy", "macro_f1", "detection_rate", "false_alarm_rate")
    log(f"  [{label}] evaluate_detection(benign_class=0) in {took:.3f} s: "
        + json.dumps({k: rep[k] for k in keys}) + "; per-class F1 "
        + json.dumps([round(float(f), 6) for f in rep["per_class_f1"]]))
    if not (all(math.isfinite(rep[k]) for k in keys)
            and np.isfinite(rep["per_class_f1"]).all()
            and int(np.asarray(rep["support"]).sum())
            == len(learner.dataset.x_test)
            and math.isclose(rep["accuracy"], eval_acc, abs_tol=1e-6)):
        raise AssertionError(f"{label}: detection report {rep}")


def family_paths():
    """(label, config, cuts) of one round of each other family."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    vit = get_config("femnist_vit_cross_silo")
    moe = get_config("agnews_bert_fedavg")
    resnet = get_config("cifar100_resnet18_fedprox")
    tcn = get_config("iot_traffic_tcn_fedavg")
    # ResNet-18's and the TCN's cohorts are cut to 5 to pay for phase 20,
    # ViT's and MoE-BERT's depth to CUT_DEPTH for phase 23.
    return [
        ("mlp", get_config("mnist_mlp_fedavg"), "none"),
        ("resnet18", resnet.replace(
            fed=dataclasses.replace(resnet.fed, cohort_size=5)),
         "cohort_size 20 -> 5"),
        ("tcn", tcn.replace(fed=dataclasses.replace(tcn.fed, cohort_size=5)),
         "cohort_size 10 -> 5"),
        ("vit", vit.replace(
            model=dataclasses.replace(vit.model, attn_impl="flash",
                                      depth=CUT_DEPTH),
            fed=dataclasses.replace(vit.fed, cohort_size=16)),
         f"cohort_size 256 -> 16, depth 12 -> {CUT_DEPTH}"),
        ("moe_bert", moe.replace(
            model=dataclasses.replace(moe.model, name="moe_bert",
                                      num_experts=4, attn_impl="flash",
                                      depth=CUT_DEPTH),
            fed=dataclasses.replace(moe.fed, cohort_size=4, local_steps=2),
            run=dataclasses.replace(moe.run, name="moe_bert_agnews")),
         f"cohort_size 10 -> 4, local_steps 150 -> 2, depth 12 -> "
         f"{CUT_DEPTH}"),
    ]


# ε of 7c's 2 rounds (q = cohort 10 of 50 clients, z = 1.0, δ = 1e-5) by
# the JAX package's RDP accountant; tests/test_torch_port_guards.py holds
# this constant to it.  The relative tolerance allows for another numpy.
EPS_7C = 4.1187131819595315
EPS_RTOL = 1e-9
# Config #2's cohort in 7a, 7b, 7e and 8b: cut from 20 to keep the script
# in its budget.
CNN_COHORT = 10
# 7d, 8a, 8c, 9b and 10c run BERT-base at CUT_DEPTH of its 12 blocks,
# through this registry config (the script registers it in this process),
# to pay for 13a's profile and phase 23 (7d and 8c since PR 23); the
# width and every check stay.
BERT_HALF = "agnews_bert_fedavg_half"


def register_half_bert() -> None:
    from colearn_federated_learning_tpu_torch.utils import config

    base = config.get_config("agnews_bert_fedavg")
    config.CONFIGS[BERT_HALF] = base.replace(
        model=dataclasses.replace(base.model, depth=CUT_DEPTH))


BERT_DP = ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
           "--local-steps", "4", "--dp-clip", "1.0",
           "--dp-noise-multiplier", "1.0", "--dp-adaptive-clip"]


def cli_path(A, label, argv, watch=None, extra_batches=None,
             extra_steps=None):
    """Run ``cli.main(["train", *argv])`` on the card, with the kernels'
    launch counts and the peak memory reset once the learner is built;
    ``watch(learner, record)`` sees the learner before the first round
    (record None) and after each round.  Checks that every round's loss
    and the params are finite and that the flash kernels launched exactly
    depth × (steps run + evaluation batches) (K1) and depth × steps (K2,
    K3) on a flash path, and never elsewhere; ``extra_batches(learner)``
    counts forward batches beyond those (a per-client evaluation's) and
    ``extra_steps(learner)`` training steps beyond the rounds' (the
    personalized fine-tune's).  Returns (records, launches, learner)."""
    from colearn_federated_learning_tpu_torch import cli

    state = {"records": [], "steps": 0}

    def on_round(learner, rec):
        if rec is None:
            state["learner"] = learner
            fresh_peak()
            A.reset_launches()
        else:
            state["records"].append(rec)
            state["steps"] += int(learner.last_cohort["steps_run"].sum())
            extra = {k: rec[k] for k in ("dp_clip", "dp_bit_frac",
                                         "dp_epsilon", "eval_acc")
                     if k in rec}
            log(f"  [{label}] round {rec['round']}: train_loss "
                f"{rec['train_loss']:.6f} completed {rec['completed']:.0f}; "
                + json.dumps(extra))
        if watch is not None:
            watch(learner, rec)

    t0 = time.perf_counter()
    log(f"  [{label}] train " + " ".join(argv))
    cli.main(["train", *argv], on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(A.launches)
    learner, records = state["learner"], state["records"]
    cfg = learner.config
    finite = all(bool(torch.isfinite(p).all())
                 for p in learner.params.values())
    if not (finite and records
            and all(math.isfinite(r["train_loss"]) for r in records)):
        raise AssertionError(f"{label}: output is not finite")
    evals = sum("eval_loss" in r for r in records)
    eval_batches = math.ceil(len(learner.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth if cfg.model.attn_impl == "flash" else 0
    extra = extra_batches(learner) if extra_batches is not None else 0
    steps = state["steps"] + (extra_steps(learner) if extra_steps is not None
                              else 0)
    want = {"flash_forward": depth * (steps + evals * eval_batches + extra),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [{label}] s/round "
        f"{[round(r['phase_update_s'], 3) for r in records]}; eval s "
        f"{[round(r['phase_eval_s'], 3) for r in records if 'eval_loss' in r]}"
        f"; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches {launches} (exact); path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    return records, launches, learner


def scaffold_path(A):
    """7a: the server variate moves in round 0 and exactly the
    contributors' rows of the variate store change."""
    seen = {}

    def watch(learner, rec):
        if rec is None:
            seen["rows"] = [r.clone() for r in learner.variates.rows]
        elif rec["round"] == 0:
            cohort = learner.last_cohort
            want = set(cohort["clients"][cohort["contributed"]].tolist())
            changed = set()
            for old, new in zip(seen["rows"], learner.variates.rows):
                diff = (old != new).reshape(len(old), -1).any(dim=1)
                changed |= set(torch.nonzero(diff).flatten().tolist())
            c_norm = math.sqrt(sum(float(c.float().square().sum()) for c in
                                   learner.server_state.control.values()))
            log(f"  [7a] after round 0: |c| = {c_norm:.6e}; variate rows "
                f"changed {len(changed)}, contributors {len(want)}")
            if not (c_norm > 0 and changed == want):
                raise AssertionError(f"7a: |c| {c_norm}, rows changed "
                                     f"{sorted(changed)} != {sorted(want)}")
            del seen["rows"]

    return cli_path(A, "7a", ["--config", "cifar10_cnn_fedavg", "--strategy",
                              "scaffold", "--momentum", "0", "--rounds", "1",
                              "--cohort-size", str(CNN_COHORT)], watch)[1]


def fednova_path(A):
    """7b: under stragglers the clients' executed steps, and so their
    a_i, differ."""
    def watch(learner, rec):
        if rec is None:
            return
        cohort = learner.last_cohort
        log(f"  [7b] steps run {cohort['steps_run'].astype(int).tolist()}; "
            f"a_i {[round(float(a), 4) for a in cohort['nova_a']]}")
        if len(set(cohort["nova_a"].tolist())) < 2:
            raise AssertionError("7b: every client's a_i is the same")

    return cli_path(A, "7b", ["--config", "cifar10_cnn_fedavg", "--strategy",
                              "fednova", "--straggler-prob", "0.5",
                              "--rounds", "1", "--cohort-size",
                              str(CNN_COHORT)], watch)[1]


def private_paths(A):
    """7c: DP with adaptive clipping and secure aggregation on BERT-base,
    and 7c': its round 0 without the masks, whose params must agree with
    7c's to 1e-5 (the masks cancel on the card)."""
    snap = {}

    def watch(learner, rec):
        if rec is not None and rec["round"] == 0:
            snap["params"] = [p.clone() for p in learner.params.values()]

    records, launches, learner = cli_path(
        A, "7c", BERT_DP + ["--rounds", "2", "--secure-agg"], watch)
    leaked = [k for r in records for k in r if k.startswith("delta_norm")]
    eps = records[-1]["dp_epsilon"]
    log(f"  [7c] dp_clip {records[0]['dp_clip']:.6f} after round 0 (from "
        f"1.0); dp_epsilon {eps!r}, the JAX accountant's {EPS_7C!r} (q = "
        f"10/50, z = 1.0, delta 1e-5, 2 rounds; rel tol {EPS_RTOL})")
    if not (records[0]["dp_clip"] != 1.0 and not leaked
            and abs(eps - EPS_7C) <= EPS_RTOL * EPS_7C):
        raise AssertionError(f"7c: clip {records[0]['dp_clip']}, epsilon "
                             f"{eps}, keys {leaked}")
    del learner
    _, launches2, plain = cli_path(A, "7c'", BERT_DP + ["--rounds", "1"])
    err = max(float((p - q).abs().max())
              for p, q in zip(plain.params.values(), snap["params"]))
    log(f"  [7c'] params after round 0, masked vs unmasked: max abs diff "
        f"{err:.3e} (bound 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"7c': masks did not cancel: {err}")
    return launches, launches2


def krum_path(A):
    """7d: Krum on BERT-base (6 of its 12 blocks) keeps n − f = 8 of the
    10 clients."""
    records, launches, learner = cli_path(
        A, "7d", ["--config", BERT_HALF, "--attn-impl", "flash",
                  "--local-steps", "4", "--rounds", "1", "--aggregator",
                  "krum", "--trim-fraction", "0.2"])
    chosen = learner.last_cohort["selected"]
    log(f"  [7d] Krum kept {len(chosen)} of {learner.cohort_size}: "
        f"{sorted(chosen.tolist())}")
    if len(chosen) != 8:
        raise AssertionError(f"7d: Krum kept {len(chosen)}, expected 8")
    return launches


def ring_path(A):
    """7e: ring masks of degree 4 with DP on config #2."""
    records, launches, learner = cli_path(
        A, "7e", ["--config", "cifar10_cnn_fedavg", "--secure-agg",
                  "--secure-agg-neighbors", "4", "--dp-clip", "0.5",
                  "--dp-noise-multiplier", "0.5", "--rounds", "1",
                  "--cohort-size", str(CNN_COHORT)])
    cohort = learner.last_cohort
    table = cohort["partners"]
    ok = all(len(set(row.tolist())) == 4 and cid not in row
             for cid, row in zip(cohort["clients"], table))
    log(f"  [7e] partner table {table.shape}, 4 distinct partners each: {ok}")
    if not (ok and table.shape == (learner.cohort_size, 4)):
        raise AssertionError(f"7e: partner table {table}")
    return launches


def cli_phase(A):
    """Phase 7: the round's other branches through the command line."""
    paths = {}
    for label, fn in (("scaffold", scaffold_path), ("fednova", fednova_path),
                      ("krum", krum_path), ("ring_dp", ring_path)):
        t0 = time.perf_counter()
        paths[label] = fn(A)
        log(f"  {label} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["dp_secure_agg"], paths["dp"] = private_paths(A)
    log(f"  dp_secure_agg and dp in {time.perf_counter() - t0:.2f} s")
    return paths


HIER = ["--config", BERT_HALF, "--attn-impl", "flash",
        "--local-steps", "4", "--edge-groups", "2", "--edge-sync-period", "2",
        "--rounds", "3"]
SYNC_RTOL = 1e-6               # cloud model vs its float64 recomputation


def hierarchical_path(A):
    """8a: hierarchical BERT-base through ``cli.main``.  Each cloud sync
    is checked as it happens: the cloud model against the float64
    example-weighted mean of the groups' params (to ``SYNC_RTOL`` of each
    tensor's largest entry), and every group against the cloud model bit
    for bit.  After round 0 (no sync) the groups' params differ.  The
    flash kernels' launches are exact over both groups' rounds and the
    cloud evaluations."""
    from colearn_federated_learning_tpu_torch import cli

    state = {"steps": 0, "syncs": [], "eval_s": [], "round_s": [],
             "check_s": 0.0}

    def checked_sync(h, sync):
        def run(*args):
            t0 = time.perf_counter()
            before = [[p.clone() for p in g.params.values()]
                      for g in h.groups]
            w = [x / sum(h.group_examples) for x in h.group_examples]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dropped = sync(*args)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            worst = 0.0
            for i, cloud in enumerate(h.global_params.values()):
                ref = sum(wg * b[i].double() for wg, b in zip(w, before))
                top = float(ref.abs().max())
                err = float((cloud.double() - ref).abs().max())
                worst = max(worst, err / top if top > 0 else err)
            bitwise = all(torch.equal(p, c) for g in h.groups
                          for p, c in zip(g.params.values(),
                                          h.global_params.values()))
            state["syncs"].append(worst)
            state["check_s"] += time.perf_counter() - t0 - (t2 - t1)
            log(f"  [8a] cloud sync in {t2 - t1:.4f} s: max err against the "
                f"float64 mean {worst:.3e} of each tensor's largest entry "
                f"(bound {SYNC_RTOL}); every group equals the cloud bit for "
                f"bit: {bitwise}")
            if not (worst <= SYNC_RTOL and bitwise):
                raise AssertionError(f"8a: sync err {worst}, bitwise {bitwise}")
            return dropped
        return run

    def timed_eval(evaluate):
        def run():
            t0 = time.perf_counter()
            out = evaluate()
            torch.cuda.synchronize()
            state["eval_s"].append(time.perf_counter() - t0)
            return out
        return run

    def on_round(h, rec):
        if rec is None:
            state["h"] = h
            h._cloud_sync = checked_sync(h, h._cloud_sync)
            h.evaluate = timed_eval(h.evaluate)
            fresh_peak()
            A.reset_launches()
            state["t"] = time.perf_counter()
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        evals = state["eval_s"][-1] if "eval_loss" in rec else 0.0
        # The round's own time: the checks above are not the learner's.
        state["round_s"].append(now - state["t"] - evals - state["check_s"])
        state["t"], state["check_s"] = now, 0.0
        state["steps"] += sum(int(g.last_cohort["steps_run"].sum())
                              for g in h.groups)
        log(f"  [8a] round {rec['round']}: synced {rec['synced']} "
            f"group losses {[round(x, 6) for x in rec['group_losses']]} "
            f"in {state['round_s'][-1]:.3f} s"
            + (f"; cloud eval loss {rec['eval_loss']:.6f} acc "
               f"{rec['eval_acc']:.4f} in {evals:.3f} s"
               if "eval_loss" in rec else ""))
        if rec["round"] == 0:
            differ = any(not torch.equal(p, q) for p, q in zip(
                h.groups[0].params.values(), h.groups[1].params.values()))
            if rec["synced"] or not differ:
                raise AssertionError("8a: the groups did not part in round 0")

    t0 = time.perf_counter()
    log("  [8a] train " + " ".join(HIER))
    summary = cli.main(["train", *HIER], on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(A.launches)
    h = state["h"]
    cfg = h.config
    finite = all(bool(torch.isfinite(p).all())
                 for p in h.global_params.values())
    evals = sum("eval_loss" in r for r in h.history)
    eval_batches = math.ceil(len(h.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth
    want = {"flash_forward": depth * (state["steps"] + evals * eval_batches),
            "flash_backward_dq": depth * state["steps"],
            "flash_backward_dkv": depth * state["steps"]}
    ok = (finite and summary["rounds"] == 3 and len(state["syncs"]) == 2
          and evals == 2 and math.isfinite(summary["final_loss"])
          and [r["synced"] for r in h.history] == [False, True, True])
    if not ok:
        raise AssertionError(f"8a: summary {summary}, syncs {state['syncs']}")
    if launches != want:
        raise AssertionError(f"8a: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [8a] {len(h.groups)} groups x {h.groups[0].num_clients} clients, "
        f"cohort {h.groups[0].cohort_size} each; s/round "
        f"{[round(x, 3) for x in state['round_s']]}; cloud eval s "
        f"{[round(x, 3) for x in state['eval_s']]}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{launches} (exact); summary {json.dumps(summary)}; path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    log("  [8a] mask_cost_summary " + json.dumps(h.mask_cost_summary()))
    return launches


def clustered_path(A):
    """8b: clustered FL on config #2 (cohort ``CNN_COHORT``) with a
    second concept planted on clients 50-99 (y -> 9 - y): 1 warm-up round,
    the update similarity after 3 steps, two clusters, one round each,
    per-client report."""
    from colearn_federated_learning_tpu_torch.fed import (
        ClusteredLearner, FederatedLearner)
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    t_path = time.perf_counter()
    cfg = get_config("cifar10_cnn_fedavg")
    base = FederatedLearner(cfg.replace(fed=dataclasses.replace(
        cfg.fed, cohort_size=CNN_COHORT)))
    n = base.num_clients
    planted = np.arange(n) >= n // 2
    base.y[n // 2:] = 9 - base.y[n // 2:]
    seen, times = {}, {}
    similarity = base.client_update_similarity

    def captured(steps):
        t0 = time.perf_counter()
        seen["sim"] = similarity(steps=steps)
        times["similarity"] = time.perf_counter() - t0
        return seen["sim"]

    base.client_update_similarity = captured
    clustered = ClusteredLearner(base, num_clusters=2)
    fresh_peak()
    A.reset_launches()
    t0 = time.perf_counter()
    labels = clustered.cluster_and_specialize(warmup_rounds=1, sim_steps=3)
    times["cluster_and_specialize"] = time.perf_counter() - t0
    sim = seen["sim"]
    asym = float(np.abs(sim - sim.T).max())
    diag = float(np.abs(np.diag(sim) - 1.0).max())
    members = np.sort(np.concatenate(clustered.members))
    agree = float(max(np.mean(labels == planted), np.mean(labels != planted)))
    log(f"  [8b] similarity {sim.shape} in {times['similarity']:.3f} s: "
        f"max |S - S^T| {asym:.2e} (bound 1e-5), max |diag - 1| {diag:.2e} "
        f"(bound 1e-4); mean within the planted concepts "
        f"{sim[np.ix_(planted, planted)].mean():.4f} / "
        f"{sim[np.ix_(~planted, ~planted)].mean():.4f}, across "
        f"{sim[np.ix_(planted, ~planted)].mean():.4f}")
    log(f"  [8b] cluster sizes {[int(m.size) for m in clustered.members]}; "
        f"labels agree with the planted concept on {agree:.2%} of clients "
        f"(reported, not gated)")
    if not (sim.shape == (n, n) and asym <= 1e-5 and diag <= 1e-4
            and np.array_equal(members, np.arange(n))):
        raise AssertionError(f"8b: similarity {sim.shape}, asym {asym}, "
                             f"diag {diag}, members {members}")
    t0 = time.perf_counter()
    clustered.fit(rounds=1)
    times["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = clustered.evaluate_per_client()
    times["evaluate_per_client"] = time.perf_counter() - t0
    launches = dict(A.launches)
    finite = all(bool(torch.isfinite(p).all()) for c in clustered.clusters
                 if c is not None for p in c.params.values())
    scalars = [v for k, v in rep.items() if isinstance(v, float)]
    log(f"  [8b] report {json.dumps(rep)}; cluster records "
        + json.dumps([c.history[-1] for c in clustered.clusters
                      if c is not None]))
    if not (finite and all(math.isfinite(v) for v in scalars)
            and sum(rep["cluster_sizes"]) == n):
        raise AssertionError(f"8b: output is not finite: {rep}")
    if any(launches.values()):
        raise AssertionError(f"8b: flash kernels launched on the CNN path: "
                             f"{launches}")
    log(f"  [8b] seconds {json.dumps({k: round(v, 3) for k, v in times.items()})}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; path "
        f"{time.perf_counter() - t_path:.2f} s; {card()}")
    return launches


PERSONALIZE_STEPS = 5      # 8c's --personalize-steps


def per_client_eval_path(A):
    """8c: one round of BERT-base at 6 of its 12 blocks, then
    ``--per-client-eval``,
    ``--personalize-steps 5`` and ``--detection-eval`` in the same
    process: every report is finite, the personalized one covers all 50
    clients, and K1-K3 launched exactly: K2 and K3 once per layer for each
    of the 5 fine-tune steps of every client, K1 for those steps too, for
    every per-client chunk, for the global and the personalized scoring
    chunks of every client's holdout half, and for every test batch of
    the confusion scan.  Each evaluation's seconds are printed."""
    seen = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            seen[name] = fn(*a, **kw)
            torch.cuda.synchronize()
            seen[name + "_s"] = time.perf_counter() - t0
            return seen[name]
        return run

    def watch(learner, rec):
        if rec is None:
            for name in ("evaluate_per_client", "evaluate_personalized",
                         "evaluate_detection"):
                setattr(learner, name, timed(name, getattr(learner, name)))

    def batch(learner):
        return max(learner.config.fed.batch_size, 64)

    def holdout_chunks(learner):
        b = batch(learner)
        return sum(math.ceil((int(c) - int(c) // 2) / b)
                   for c in learner.counts if int(c) >= 2)

    def chunks(learner):
        b = batch(learner)
        per_client = sum(math.ceil(int(c) / b) for c in learner.counts)
        test = math.ceil(len(learner.dataset.x_test) / b)
        return per_client + 2 * holdout_chunks(learner) + test

    def fine_tune_steps(learner):
        return PERSONALIZE_STEPS * sum(int(c) >= 2 for c in learner.counts)

    _, launches, learner = cli_path(
        A, "8c", ["--config", BERT_HALF, "--attn-impl", "flash",
                  "--local-steps", "4", "--rounds", "1",
                  "--per-client-eval", "--personalize-steps",
                  str(PERSONALIZE_STEPS), "--detection-eval"], watch,
        extra_batches=chunks, extra_steps=fine_tune_steps)
    rep = seen["evaluate_per_client"]
    values = [rep[k] for k in ("weighted_loss", "weighted_acc", "acc_p10",
                               "acc_p50", "acc_p90")]
    log(f"  [8c] per-client evaluation of {len(rep['per_client_acc'])} "
        f"clients in {seen['evaluate_per_client_s']:.3f} s: "
        + json.dumps({k: rep[k] for k in ("weighted_loss", "weighted_acc",
                                          "acc_p10", "acc_p50", "acc_p90")}))
    if not (all(math.isfinite(v) for v in values)
            and np.isfinite(rep["per_client_loss"]).all()
            and len(rep["per_client_acc"]) == learner.num_clients):
        raise AssertionError(f"8c: report is not finite: {rep}")
    pers = seen["evaluate_personalized"]
    keys = ("global_acc", "personalized_acc", "personalization_gain")
    log(f"  [8c] personalized evaluation ({PERSONALIZE_STEPS} fine-tune "
        f"steps, {fine_tune_steps(learner)} in all; "
        f"{2 * holdout_chunks(learner)} scoring chunks) of "
        f"{pers['num_clients_evaluated']} clients in "
        f"{seen['evaluate_personalized_s']:.3f} s: "
        + json.dumps({k: pers[k] for k in keys}))
    if not (all(math.isfinite(pers[k]) for k in keys)
            and np.isfinite(pers["per_client_global_acc"]).all()
            and np.isfinite(pers["per_client_personalized_acc"]).all()
            and pers["num_clients_evaluated"] == 50
            and learner.num_clients == 50):
        raise AssertionError(f"8c: personalized report {pers}")
    det = seen["evaluate_detection"]
    dkeys = ("accuracy", "macro_f1", "detection_rate", "false_alarm_rate")
    log(f"  [8c] detection evaluation over "
        f"{int(np.asarray(det['support']).sum())} test examples in "
        f"{seen['evaluate_detection_s']:.3f} s: "
        + json.dumps({k: det[k] for k in dkeys}))
    if not (all(math.isfinite(det[k]) for k in dkeys)
            and np.isfinite(det["per_class_f1"]).all()
            and int(np.asarray(det["support"]).sum())
            == len(learner.dataset.x_test)):
        raise AssertionError(f"8c: detection report {det}")
    return launches


def slice_phase(A):
    """Phase 8: the hierarchical and clustered learners and per-client
    evaluation."""
    paths = {}
    for label, fn in (("hierarchical", hierarchical_path),
                      ("clustered", clustered_path),
                      ("per_client_eval", per_client_eval_path)):
        t0 = time.perf_counter()
        paths[label] = fn(A)
        log(f"  {label} in {time.perf_counter() - t0:.2f} s")
    return paths


# ------------------------------------------------------------ phase 9 (B4)
FOLD_KERNELS = {
    "fold_sparse": "colearn_federated_learning_tpu/ops/fold_kernel.py:239",
    "fold_dense": "colearn_federated_learning_tpu/ops/fold_kernel.py:269",
}
FOLD_SOURCE = "colearn_federated_learning_tpu_torch/csrc/fold.cu"
FOLD_ROWS = 10                 # contributions per 9a batch
TOPK_FRACTION = 0.05           # the JAX package's default keep density
SECTOR = 32                    # bytes the card moves per scattered access
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
FILE_PLANE = ["--config", BERT_HALF, "--attn-impl", "flash",
              "--local-steps", "4"]
SILOS = 2                  # cut from 4 to keep the script in its budget


def sparse_batch(sizes, rows, int8, seed):
    """``rows`` topk-like contributions over the slot layout ``sizes``:
    each entry kept with probability TOPK_FRACTION (unique, sorted
    indices), int8 values with a per-slot scale or float32 values, a
    float32 weight.  Drawn on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    batch = []
    for _ in range(rows):
        keep = torch.rand(int(offs[-1]), generator=g, device="cuda")
        gidx = torch.nonzero(keep < TOPK_FRACTION).flatten()
        if int8:
            vals = torch.randint(-127, 128, gidx.shape, generator=g,
                                 device="cuda").to(torch.int8)
        else:
            vals = torch.randn(gidx.shape, generator=g, device="cuda")
        gidx, vals = gidx.cpu().numpy(), vals.cpu().numpy()
        cut = np.searchsorted(gidx, offs)
        slots = [(gidx[cut[s]:cut[s + 1]] - offs[s], vals[cut[s]:cut[s + 1]],
                  np.float32(rng.uniform(1e-4, 1e-2)) if int8
                  else np.float32(1.0)) for s in range(len(sizes))]
        batch.append((np.float32(rng.uniform(1.0, 300.0)), slots))
    return batch


def plain_sparse(F, kernel, st, acc):
    """The plain version over a staged batch, contribution by contribution
    as the kernel's launches go."""
    for part in st.parts:
        set_mode = acc is None
        if set_mode:
            acc = torch.zeros(kernel.total, dtype=torch.float32,
                              device="cuda")
        F.fold_sparse_reference(acc, part.idx, part.vals, part.begin,
                                part.scales, kernel.slot_off,
                                float(part.weight), set_mode)
    return acc


def global_entries(kernel, part):
    """A staged contribution's flat accumulator indices and per-entry
    scales."""
    e = torch.arange(part.idx.numel(), device="cuda")
    s = torch.searchsorted(part.begin, e, right=True) - 1
    return kernel.slot_off[s] + part.idx.long(), part.scales[s]


def staged_bytes(part) -> int:
    """Bytes of one staged contribution's tensors (each read once)."""
    return sum(t.numel() * t.element_size() for t in
               (part.idx, part.vals, part.begin, part.scales, part.tiles))


def bits_equal(what, got, want):
    """Hold ``got`` to ``want`` bit for bit (int32 views); returns the max
    abs difference (0.0)."""
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{what}: {bad} entries differ from the plain "
                             "version")
    return float((got - want).abs().max())


def fold_check_phase(F):
    """9a: the fold kernel against its plain version at BERT-base's slot
    layout, bitwise; then its device time, the staging copy's, the plain
    version's, ``index_add_``'s and the bound, and the overlapped
    ``fold_sparse`` call per contribution: its pack, copy and kernel times
    and its whole time by the host clock up to a sync."""
    from colearn_federated_learning_tpu_torch.utils import trees

    shapes = bert_params()
    sizes = [int(np.asarray(l).size) for l in trees.leaves(shapes)]
    kernel = F.get_kernel(sizes)
    log(f"  BERT-base layout: {len(sizes)} slots, {kernel.total} f32 entries")
    errs = {"fold_sparse": 0.0, "fold_dense": 0.0}
    rows = {}
    staged = {}
    for int8, label in ((True, "topk8"), (False, "topk")):
        t0 = time.perf_counter()
        batch = sparse_batch(sizes, FOLD_ROWS, int8, 90 + int(int8))
        t_draw = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = kernel.stage_sparse(batch)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        if {p.idx.dtype for p in st.parts} != {torch.int32}:
            raise AssertionError(f"9a {label}: indices not staged as int32")
        got = kernel.fold_sparse_staged(None, st)
        want = plain_sparse(F, kernel, st, None)
        errs["fold_sparse"] = max(errs["fold_sparse"], bits_equal(
            f"9a {label} x {FOLD_ROWS}", got, want))
        # Folding on into the accumulator adds, in order.
        errs["fold_sparse"] = max(errs["fold_sparse"], bits_equal(
            f"9a {label} onto an accumulator",
            kernel.fold_sparse_staged(got, st), plain_sparse(F, kernel, st,
                                                             want)))
        # The overlapped call (pack, copy and launch per contribution).
        errs["fold_sparse"] = max(errs["fold_sparse"], bits_equal(
            f"9a {label} through fold_sparse",
            kernel.fold_sparse(None, batch), plain_sparse(F, kernel, st,
                                                          None)))
        first = kernel.stage_sparse(batch[:1])
        bits_equal(f"9a {label} first contribution",
                   kernel.fold_sparse_staged(None, first),
                   plain_sparse(F, kernel, first, None))
        staged[label] = (st, batch)
        log(f"  {label}: {FOLD_ROWS} contributions of "
            f"{st.entries / FOLD_ROWS:.0f} entries on average bitwise equal "
            f"to the plain version (from zeros, onto an accumulator, "
            f"through the overlapped fold_sparse, a first contribution "
            f"alone); drawn in {t_draw:.2f} s, staged in {t_stage:.2f} s")
        del got, want
    # A -0.0 assigned first and touched by nothing later survives.
    empty = [(np.zeros(0, np.int64), np.zeros(0, np.float32),
              np.float32(1.0))] * len(sizes)
    zero_first = list(empty)
    zero_first[0] = (np.array([3], np.int64), np.array([-0.0], np.float32),
                     np.float32(1.0))
    later = list(empty)
    later[0] = (np.array([1], np.int64), np.array([1.5], np.float32),
                np.float32(1.0))
    later[5] = (np.array([0, 7], np.int64), np.array([-2.0, 0.25],
                                                     np.float32),
                np.float32(1.0))
    nz = [(np.float32(1.0), zero_first), (np.float32(2.0), later)]
    st = kernel.stage_sparse(nz)
    got = kernel.fold_sparse_staged(None, st)
    bits_equal("9a -0.0", got, plain_sparse(F, kernel, st, None))
    if not (float(got[3]) == 0.0 and math.copysign(1.0, float(got[3])) < 0):
        raise AssertionError("9a: the staged -0.0 did not survive")
    bits_equal("9a -0.0 through fold_sparse", kernel.fold_sparse(None, nz),
               got)
    log("  a -0.0 assigned by the first contribution survives the rest")
    del got

    # Dense: 10 full-width contributions, adopted then added in order.
    g = torch.Generator(device="cuda").manual_seed(93)
    offs = kernel.offsets
    dense = []
    for _ in range(FOLD_ROWS):
        flat = torch.randn(kernel.total, generator=g, device="cuda")
        flat = flat.cpu().numpy()
        dense.append([flat[a:b] for a, b in zip(offs[:-1], offs[1:])])
    t0 = time.perf_counter()
    x = kernel.stage_dense(dense)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    got = kernel.fold_dense_staged(None, x)
    want = F.fold_dense_reference(torch.empty_like(got), x, True)
    errs["fold_dense"] = bits_equal(f"9a dense x {FOLD_ROWS}", got, want)
    bits_equal("9a dense onto an accumulator",
               kernel.fold_dense_staged(got, x[:2]),
               F.fold_dense_reference(want, x[:2], False))
    log(f"  dense: {FOLD_ROWS} contributions of {kernel.total} entries "
        f"bitwise equal to the plain version (adopted, then onto an "
        f"accumulator); staged in {t_stage:.2f} s")
    del dense, got, want

    # Timing (``sparse_row``, ``dense_row``), with the wrapper loop, the
    # staging copy and the overlapped call beside the device time.
    for int8, label in ((True, "topk8"), (False, "topk")):
        st, batch = staged[label]
        acc = torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
        row, nbytes, in_bytes = sparse_row(F, kernel, st, acc, FOLD_ROWS)
        ms = row["ms"]
        wrapper = time_ms(lambda: kernel.fold_sparse_staged(acc, st),
                          iters=5) / FOLD_ROWS
        # The copy of one contribution's region, pinned host -> device.
        h2d_bytes = max(staged_bytes(p) for p in st.parts)
        dst = torch.empty(h2d_bytes, dtype=torch.uint8, device="cuda")
        h2d = time_ms(lambda: dst.copy_(kernel._pinned[:h2d_bytes],
                                        non_blocking=True), iters=5)
        overlap = fold_call_times(F, kernel, acc, batch)
        row = {"ms": ms, "wrapper_ms": wrapper, "plain_ms": row["plain_ms"],
               "library_ms": row["library_ms"], "h2d_ms": h2d,
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "max_abs_err": errs["fold_sparse"], **overlap}
        log(f"  fold_sparse {label} per contribution: {ms * 1e3:.2f} us "
            f"device ({row['bound_ms'] / ms:.1%} of bound "
            f"{row['bound_ms'] * 1e3:.2f} us, {row['bound_by']}: "
            f"{nbytes / 1e6:.2f} MB with 32-byte sectors, "
            f"{in_bytes / st.entries:.3f} staged bytes per entry); wrapper "
            f"loop {wrapper * 1e3:.2f} us; H2D copy of "
            f"{h2d_bytes / 1e6:.2f} MB {h2d * 1e3:.2f} us; plain "
            f"{row['plain_ms'] * 1e3:.2f} us; index_add_ "
            f"{row['library_ms'] * 1e3:.2f} us")
        log(f"  fold_sparse {label} call per contribution (overlapped): "
            f"pack {overlap['pack_ms'] * 1e3:.2f} us host, copy "
            f"{overlap['copy_ms'] * 1e3:.2f} us, kernel "
            f"{overlap['kernel_ms'] * 1e3:.2f} us device; whole call "
            f"{overlap['call_ms'] * 1e3:.2f} us by the host clock to a sync "
            f"(median of {overlap['calls']} calls of {FOLD_ROWS}); "
            + json.dumps({"label": label, **row}))
        if int8:
            rows["fold_sparse"] = row
        del acc, dst
    d = dense_row(F, kernel, x)
    pinned = kernel._pinned
    h2d = time_ms(lambda: pinned[:x.numel() * 4].to("cuda", non_blocking=True),
                  iters=3)
    r = rows["fold_dense"] = {
        "ms": d["ms"], "wrapper_ms": time_ms(
            lambda: kernel.fold_dense_staged(None, x), iters=3),
        "plain_ms": d["plain_ms"], "library_ms": d["library_ms"],
        "h2d_ms": h2d, "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "max_abs_err": errs["fold_dense"]}
    log(f"  fold_dense, {FOLD_ROWS} rows of {kernel.total}: "
        f"{r['ms'] * 1e3:.2f} us device ({r['bound_ms'] / r['ms']:.1%} of "
        f"bound {r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}); H2D staging "
        f"copy {h2d * 1e3:.2f} us; plain {r['plain_ms'] * 1e3:.2f} us; "
        f"torch.sum {r['library_ms'] * 1e3:.2f} us; {card()}")
    # The root's shape in 12a: 2 partials, adopted and added.
    two = x[:2]
    sum2 = device_ms(lambda s: torch.sum(s, dim=0), [two])
    dense2 = device_ms(lambda s: kernel.fold_dense_staged(None, s), [two])
    log(f"  fold_dense of 2 partials (the root's shape in 12a): "
        f"{dense2 * 1e3:.2f} us device; torch.sum {sum2 * 1e3:.2f} us")
    return rows


def sparse_row(F, kernel, st, acc, rows: int) -> tuple[dict, float, int]:
    """The sparse launch over the staged batch ``st`` (``rows``
    contributions) onto the standing accumulator ``acc``, per
    contribution: its device time (CUDA-graph replay), the plain
    version's and ``index_add_``'s (events around a host loop: neither is
    captured, the plain version's ``index_put_`` sorts) and the bound,
    each staged byte read once (the tensors' own element sizes) and each
    touched 32-byte sector of the accumulator read and written once.
    Returns ``(row, bytes per contribution, staged bytes)``."""
    ms = device_ms(lambda s: kernel.fold_sparse_staged(acc, s), [st]) / rows
    plain = time_ms(lambda: plain_sparse(F, kernel, st, acc),
                    iters=3) / rows
    entries = [global_entries(kernel, p) for p in st.parts]

    def yardstick():
        for (gi, sc), p in zip(entries, st.parts):
            acc.index_add_(0, gi, (p.vals.float() * sc) * float(p.weight))

    library = time_ms(yardstick, iters=3) / rows
    in_bytes = sum(staged_bytes(p) for p in st.parts)
    nbytes = (in_bytes + sum(SECTOR * 2 * int(torch.unique_consecutive(
        gi // (SECTOR // 4)).numel()) for gi, _ in entries)) / rows
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * st.entries / rows / F32_FLOP_PER_S
    return ({"ms": ms, "plain_ms": plain, "library_ms": library,
             "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
            nbytes, in_bytes)


def dense_row(F, kernel, x) -> dict:
    """The dense launch over the staged rows ``x``: its device time, the
    plain version's, ``torch.sum``'s over the same rows and the bytes
    bound (the rows read once, the accumulator written once)."""
    ms = device_ms(lambda s: kernel.fold_dense_staged(None, s), [x])
    out = torch.empty(kernel.total, dtype=torch.float32, device="cuda")
    plain = time_ms(lambda: F.fold_dense_reference(out, x, True), iters=3)
    library = device_ms(lambda s: torch.sum(s, dim=0), [x])
    t_bytes = (x.numel() * 4 + kernel.total * 4) / HBM_BYTES_PER_S
    t_ops = x.numel() / F32_FLOP_PER_S
    return {"ms": ms, "plain_ms": plain, "library_ms": library,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fold_call_times(F, kernel, acc, batch, calls: int = 5) -> dict:
    """The overlapped ``fold_sparse`` call folding ``batch`` onto ``acc``,
    per contribution: the median whole call by the host clock from a sync
    to a sync, and, in calls of their own, the host's pack, the copy's and
    the kernel's device spans (means)."""
    n = len(batch)
    whole = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel.fold_sparse(acc, batch)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) / n)
    timer = _FoldTimer(F)
    try:
        for _ in range(calls):
            kernel.fold_sparse(acc, batch)
        spans = {k: timer.per_contribution_us(k)
                 for k in ("pack", "stage", "sparse")}
    finally:
        timer.close()
    return {"call_ms": float(np.median(whole)) * 1e3,
            "pack_ms": spans["pack"] / 1e3, "copy_ms": spans["stage"] / 1e3,
            "kernel_ms": spans["sparse"] / 1e3, "calls": calls}


def file_plane_path(A, F, workdir):
    """9b: the file plane at BERT-base width through ``cli.main``: init,
    SILOS silos of ``train --role client --compress topk8``, aggregate,
    eval; then the same update files through ``StreamingFolder(device_fold
    =True)``, flat and as a two-aggregator tree, each bitwise equal to its
    host fold, the flat mean within 1e-6 of aggregate's mean delta (of its
    largest entry) and the new global model exactly the old plus that
    mean.  K1-K3's and the fold's launches are exact."""
    import os

    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.fed import offline
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        load_pytree_npz)

    g0, g1 = f"{workdir}/global0.npz", f"{workdir}/global1.npz"
    ups = [f"{workdir}/update{c}.npz" for c in range(SILOS)]
    fresh_peak()
    A.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    log("  [file plane] " + " ".join(["init", *FILE_PLANE]))
    cli.main(["init", *FILE_PLANE, "--out", g0])
    client_s = []
    for cid, out in enumerate(ups):
        t1 = time.perf_counter()
        stats = cli.main(["train", *FILE_PLANE, "--role", "client",
                          "--client-id", str(cid), "--global-model", g0,
                          "--out", out, "--compress", "topk8"])
        client_s.append(time.perf_counter() - t1)
        if not (math.isfinite(stats["mean_loss"]) and stats["weight"] > 0):
            raise AssertionError(f"9b: bad client stats {stats}")
    t1 = time.perf_counter()
    agg = cli.main(["aggregate", *FILE_PLANE, "--global-model", g0,
                    "--updates", *ups, "--out", g1])
    agg_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ev = cli.main(["eval", *FILE_PLANE, "--global-model", g1])
    eval_s = time.perf_counter() - t1
    if not (agg["round"] == 1 and agg["num_updates"] == SILOS
            and math.isfinite(ev["eval_loss"]) and 0 <= ev["eval_acc"] <= 1):
        raise AssertionError(f"9b: aggregate {agg}, eval {ev}")
    torch.cuda.synchronize()
    launches = dict(A.launches)
    config = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *FILE_PLANE]))
    from colearn_federated_learning_tpu_torch.data import registry
    n_test = len(registry.get_dataset(config.data.dataset,
                                      seed=config.run.seed).x_test)
    depth, steps = config.model.depth, SILOS * config.fed.local_steps
    eval_batches = math.ceil(n_test / max(config.fed.batch_size, 64))
    want = {"flash_forward": depth * (steps + eval_batches),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"9b: kernel launches {launches}, expected "
                             f"{want}")
    size_mb = sum(os.path.getsize(u) for u in ups) / SILOS / 1e6
    log(f"  [file plane] clients {[round(t, 2) for t in client_s]} s "
        f"(update files {size_mb:.1f} MB each); aggregate {agg_s:.2f} s; "
        f"eval {eval_s:.2f} s: loss {ev['eval_loss']:.6f} acc "
        f"{ev['eval_acc']:.4f}; launches {launches} (exact)")

    # The same files through the folders, host and on the card.
    params, _ = load_pytree_npz(g0)
    files = [load_pytree_npz(u) for u in ups]
    order = [str(c) for c in range(SILOS)]

    def folder(device_fold, subset=None, **kw):
        f = StreamingFolder(params, order=order, device_fold=device_fold,
                            **kw)
        for wire, meta in (files if subset is None
                           else [files[c] for c in subset]):
            f.add(dict(meta), wire)
        f.finalize()
        return f

    def same(what, a, b):
        if not (a.total_w == b.total_w and a.loss_sum == b.loss_sum
                and all(x.tobytes() == y.tobytes() for x, y in
                        zip(trees.leaves(a.wsum), trees.leaves(b.wsum)))):
            raise AssertionError(f"9b: {what} differs from the host fold")

    t1 = time.perf_counter()
    host = folder(False)
    host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev = folder(True)
    dev_s = time.perf_counter() - t1
    same("the device fold", dev, host)
    mean, total_w, _ = dev.mean()
    ref = offline.mean_update(config, params, 0, ups)
    if ref["accepted"] != SILOS or ref["total_weight"] != total_w:
        raise AssertionError(f"9b: aggregate's fold {ref['accepted']} / "
                             f"{ref['total_weight']}")
    ref_mean = [t.cpu().numpy() for t in trees.leaves(ref["mean_delta"])]
    top = max(float(np.abs(m).max()) for m in ref_mean)
    err = max(float(np.abs(a - b).max())
              for a, b in zip(trees.leaves(mean), ref_mean))
    if err > 1e-6 * top:
        raise AssertionError(f"9b: folder mean vs aggregate's mean delta "
                             f"{err} > 1e-6 x {top}")
    new, _ = load_pytree_npz(g1)
    lr = np.float32(config.fed.server_lr)
    if not all(np.array_equal(n, p + m * lr)
               for n, p, m in zip(trees.leaves(new), trees.leaves(params),
                                  ref_mean)):
        raise AssertionError("9b: the new global model is not the old plus "
                             "the mean delta")
    # Two aggregators fold two files each; the root folds their partials.
    halves = [list(range(SILOS // 2)), list(range(SILOS // 2, SILOS))]
    root = StreamingFolder(params, order=["agg:0", "agg:1"],
                           device_fold=True)
    for i, half in enumerate(halves):
        leaf = folder(True, half)
        root.add_partial(f"agg:{i}", leaf.total_w, leaf.wsum, leaf.loss_sum,
                         count=len(half))
    root.finalize()
    same("the two-aggregator tree", root,
         folder(False, slices=[[str(c) for c in h] for h in halves]))
    torch.cuda.synchronize()
    fold_launches = dict(F.launches)
    want = {"fold_sparse": 2 * SILOS, "fold_dense": 1}
    if fold_launches != want:
        raise AssertionError(f"9b: fold launches {fold_launches}, expected "
                             f"{want}")
    log(f"  [file plane] StreamingFolder: host {host_s:.2f} s, device "
        f"{dev_s:.2f} s, bitwise equal; mean vs aggregate's {err:.3e} "
        f"(bound 1e-6 x {top:.3e}); tree bitwise equal to the sliced host "
        f"fold; fold launches {fold_launches} (exact); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; path "
        f"{time.perf_counter() - t0:.2f} s; cuts: local_steps 150 -> 4, "
        f"{SILOS} silos")
    return {**launches, **fold_launches}


def bench_path():
    """9c: the port's ``bench`` with its defaults on the card."""
    from colearn_federated_learning_tpu_torch import cli

    out = cli.main(["bench"])
    if not (out["platform"] == "gpu" and out["value"] > 0
            and out["metric"] == "fedavg_cifar10_cnn_rounds_per_sec"
            and out["vs_baseline"] > 0 and out.get("card")):
        raise AssertionError(f"9c: bad bench line {out}")
    return out


# ------------------------------------------------------------ phase 10
REMAT_RTOL, REMAT_ATOL = 1e-4, 2e-5     # bound of the remat differences
MESH_ATOL = 2e-5                         # world-1 mesh vs one device


REMAT_ROUNDS = 1           # cut from 2 to keep the script in its budget


def remat_path(A, label, cfg):
    """10a: ``REMAT_ROUNDS`` rounds of ``cfg`` without and with remat on
    the same plan (the default draws of one seed): the losses and params
    must agree (expected 0.0: the recomputed forward runs the same kernels
    on the same inputs), and K1 launches once more per block and step
    under remat.  The round pays one-time costs (cudnn's and the
    allocator's warm-up).  Returns the remat run's launches and the
    numbers."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    runs = []
    for remat in (False, True):
        learner = FederatedLearner(cfg.replace(model=dataclasses.replace(
            cfg.model, remat=remat)))
        fresh_peak()
        A.reset_launches()
        losses, secs, steps = [], [], 0
        for _ in range(REMAT_ROUNDS):
            t0 = time.perf_counter()
            losses.append(learner.run_round()["train_loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            steps += int(learner.last_cohort["steps_run"].sum())
        launches = dict(A.launches)
        depth = cfg.model.depth
        want = {"flash_forward": depth * steps * (2 if remat else 1),
                "flash_backward_dq": depth * steps,
                "flash_backward_dkv": depth * steps}
        if launches != want:
            raise AssertionError(f"{label} remat={remat}: kernel launches "
                                 f"{launches}, expected {want}")
        runs.append((losses, [p.clone() for p in learner.params.values()],
                     torch.cuda.max_memory_allocated() / 2**30, secs,
                     launches))
        del learner
    (l0, p0, peak0, s0, _), (l1, p1, peak1, s1, launches) = runs
    loss_diff = max(abs(a - b) for a, b in zip(l0, l1))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
    bound = max(REMAT_ATOL + REMAT_RTOL * float(a.abs().max()) for a in p0)
    log(f"  [{label}] remat vs plain: loss diff {loss_diff:.3e}, params max "
        f"abs diff {param_diff:.3e} (bound {REMAT_RTOL:g} rel / "
        f"{REMAT_ATOL:g} abs); peak {peak0:.3f} -> {peak1:.3f} GiB; "
        f"s/round {[round(t, 3) for t in s0]} -> "
        f"{[round(t, 3) for t in s1]}; K1 launches under remat "
        f"{launches['flash_forward']} (exact); {card()}")
    if not (loss_diff <= REMAT_ATOL + REMAT_RTOL * max(map(abs, l0))
            and param_diff <= bound):
        raise AssertionError(f"{label}: remat changed the round: loss "
                             f"{loss_diff}, params {param_diff}")
    return launches, dict(loss_diff=loss_diff, param_diff=param_diff,
                          peak_gib=(peak0, peak1), s_round=(s0, s1))


MESH_CASES = {
    "fedavg": ({}, {"all_reduce": 3}),
    "dp_secure_agg": (dict(dp_clip=1.0, dp_noise_multiplier=1.0,
                           secure_agg=True),
                      {"all_gather": 1, "all_reduce": 2}),
    "krum": (dict(aggregator="krum", trim_fraction=0.25),
             {"all_gather": 2, "all_reduce": 2}),
}
MESH_CLIENTS = 4


def mesh_world1_path(A):
    """10b: the client-mesh round at world size 1 on NCCL (a FileStore in
    a temporary directory, ``init_device_mesh("cuda", (1,), ("clients",))``):
    config #4 at 6 of BERT-base's 12 blocks (width 768), 4 clients in full
    participation, 4 steps,
    plain FedAvg, DP with secure aggregation, and Krum; each round's
    params equal the single-device learner's on the same plan, its
    collectives are exactly those of its path, and the kernels' launches
    are exact.  The process group is destroyed after the phase."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.parallel import collectives

    base = main_path_config()
    base = base.replace(model=dataclasses.replace(base.model,
                                                  depth=CUT_DEPTH))
    depth = base.model.depth
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,),
                                    mesh_dim_names=("clients",))
            for label, (fed_kw, want_calls) in MESH_CASES.items():
                cfg = base.replace(
                    data=dataclasses.replace(base.data,
                                             num_clients=MESH_CLIENTS),
                    fed=dataclasses.replace(base.fed, cohort_size=0,
                                            **fed_kw))
                out = []
                for m in (mesh, None):
                    learner = FederatedLearner(cfg, mesh=m)
                    A.reset_launches()
                    collectives.reset_counts()
                    t0 = time.perf_counter()
                    rec = learner.run_round()
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                    calls = dict(collectives.counts)
                    got = dict(A.launches)
                    steps = int(learner.last_cohort["steps_run"].sum())
                    want = {"flash_forward": depth * steps,
                            "flash_backward_dq": depth * steps,
                            "flash_backward_dkv": depth * steps}
                    if got != want:
                        raise AssertionError(f"10b {label}: launches {got}, "
                                             f"expected {want}")
                    if calls != (want_calls if m is not None else {}):
                        raise AssertionError(f"10b {label}: collectives "
                                             f"{calls}, expected {want_calls}")
                    out.append((rec, [p.clone() for p in
                                      learner.params.values()], sec, got))
                    del learner
                (rec, p_mesh, s_mesh, got), (ref, p_one, s_one, _) = out
                diff = max(float((a - b).abs().max())
                           for a, b in zip(p_mesh, p_one))
                log(f"  [10b {label}] mesh vs one device: train_loss "
                    f"{rec['train_loss']:.6f} / {ref['train_loss']:.6f}, "
                    f"params max abs diff {diff:.3e} (bound {MESH_ATOL:g}); "
                    f"collectives {want_calls} (exact); s/round "
                    f"{s_mesh:.3f} / {s_one:.3f}; launches {got} (exact); "
                    f"{card()}")
                if not (diff <= MESH_ATOL
                        and rec["completed"] == ref["completed"]
                        == MESH_CLIENTS):
                    raise AssertionError(f"10b {label}: mesh round differs "
                                         f"({diff}, {rec}, {ref})")
                launches[label] = got
        finally:
            dist.destroy_process_group()
    return launches


SINGLE_DEVICE = ["--config", BERT_HALF, "--local-steps", "2",
                 "--cohort-size", "4", "--rounds", "1"]


def single_device_paths(A):
    """10c: on one card ``train --attn-impl ring`` runs the dense core and
    gives the dense run's loss, and ``train --tp-size 2`` warns and gives
    the untiled run's loss (config #4, cohort 4, 2 local steps)."""
    import warnings

    losses = {}
    for label, extra in (("dense", ["--attn-impl", "dense"]),
                         ("ring", ["--attn-impl", "ring"]),
                         ("tp2", ["--attn-impl", "dense", "--tp-size", "2"])):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            records, _, learner = cli_path(A, f"10c {label}",
                                           SINGLE_DEVICE + extra)
        warned = [str(w.message) for w in seen if "tp_size" in str(w.message)]
        cores = {m.impl for m in learner.model.modules()
                 if hasattr(m, "impl")}
        losses[label] = records[-1]["train_loss"]
        log(f"  [10c {label}] train_loss {losses[label]!r}; attention core "
            f"{sorted(cores)}; mesh {learner.mesh}; tp warnings {warned}")
        if cores != {"dense"} or learner.mesh is not None \
                or len(warned) != (label == "tp2"):
            raise AssertionError(f"10c {label}: cores {cores}, warnings "
                                 f"{warned}")
        del learner
    if not losses["ring"] == losses["tp2"] == losses["dense"]:
        raise AssertionError(f"10c: losses differ {losses}")


def parallel_phase(A):
    """Phase 10: remat, the client mesh at world size 1, and the
    single-device semantics of the SP and TP options."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    paths, numbers = {}, {}
    t0 = time.perf_counter()
    vit = get_config("femnist_vit_cross_silo")
    bert = main_path_config()
    # Both at CUT_DEPTH of their 12 blocks (the width and the checks
    # stay), to keep the script in its budget.
    for label, cfg in (("bert", bert.replace(model=dataclasses.replace(
                            bert.model, depth=CUT_DEPTH))),
                       ("vit", vit.replace(
                           model=dataclasses.replace(vit.model,
                                                     attn_impl="flash",
                                                     depth=CUT_DEPTH),
                           fed=dataclasses.replace(vit.fed, cohort_size=8)))):
        paths[f"remat_{label}"], numbers[label] = remat_path(
            A, f"10a {label}", cfg)
    log(f"  10a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for label, got in mesh_world1_path(A).items():
        paths[f"mesh_{label}"] = got
    log(f"  10b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    single_device_paths(A)
    log(f"  10c in {time.perf_counter() - t0:.2f} s")
    log("phase 10 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 11
SOCKET_CUTS = ("local_steps 150 -> 4; 3 enrolled trainers (+ the "
               "evaluator), each one client of the 50-client partition")
SOCKET_TIMEOUT = 300.0     # s per round: the first round is the warm-up
# The masks' cancellation: 4x the f32 roundoff a sound recovery of
# BERT-base leaves (2.5e-6 on an H100); 11b shows planted faults above it.
CANCEL_ATOL = 1e-5


class _Recorder:
    """Patches ``StreamingFolder`` in ``comm.coordinator``,
    ``comm.async_coordinator`` and ``comm.aggregator`` (and optionally
    ``DeviceWorker._mask``) for one phase: keeps every folder the
    coordinators (``folders``) and the aggregators (``agg_folders``) make,
    with the updates each was given (``received``), the weights passed
    beside them (``weights``) and the seconds of its finalize
    (``finalize_s``), and each worker's delta before its masks."""

    def __init__(self, masks: bool = False):
        from colearn_federated_learning_tpu_torch.comm import (
            aggregation, aggregator, async_coordinator, coordinator, worker)

        self.folders, self.agg_folders, self.unmasked = [], [], {}
        rec = self

        def recording(kept):
            class Recording(aggregation.StreamingFolder):
                def __init__(self, *args, **kw):
                    super().__init__(*args, **kw)
                    self.received, self.weights = [], []
                    self.finalize_s = 0.0
                    kept.append(self)

                def add(self, meta, delta, weight=None):
                    self.received.append((dict(meta), delta))
                    self.weights.append(weight)
                    return super().add(meta, delta, weight)

                def finalize(self):
                    t0 = time.perf_counter()
                    super().finalize()
                    self.finalize_s += time.perf_counter() - t0
            return Recording

        self._undo = [(module, "StreamingFolder", module.StreamingFolder)
                      for module in (coordinator, async_coordinator,
                                     aggregator)]
        coordinator.StreamingFolder = recording(self.folders)
        async_coordinator.StreamingFolder = coordinator.StreamingFolder
        aggregator.StreamingFolder = recording(self.agg_folders)
        if masks:
            orig = worker.DeviceWorker._mask

            def mask(w, round_idx, cohort, delta_np):
                rec.unmasked[w.client_id] = delta_np
                return orig(w, round_idx, cohort, delta_np)

            self._undo.append((worker.DeviceWorker, "_mask", orig))
            worker.DeviceWorker._mask = mask

    def close(self):
        for obj, name, orig in self._undo:
            setattr(obj, name, orig)


class _FoldTimer:
    """While installed: CUDA events around the fold kernel's staging copies
    (a sparse contribution's on the kernel's copy stream, a dense batch's
    on the current stream), its sparse launches and its dense folds
    (device ms per call), and the host clock around the packing of each
    sparse contribution."""

    def __init__(self, F):
        self.F = F
        self.spans = {"stage": [], "sparse": [], "dense": []}
        self.pack_s = []
        K = F.FoldKernel
        self._orig = {n: K.__dict__[n] for n in
                      ("_upload", "_upload_part", "_pack_part", "_fold_part",
                       "fold_dense_staged")}
        K._upload = self._timed(self._orig["_upload"], "stage")
        K._upload_part = self._timed(self._orig["_upload_part"], "stage",
                                     copy_stream=True)
        K._fold_part = self._timed(self._orig["_fold_part"], "sparse")
        K.fold_dense_staged = self._timed(self._orig["fold_dense_staged"],
                                          "dense")
        pack = self._orig["_pack_part"].__func__

        def timed_pack(*args):
            t0 = time.perf_counter()
            out = pack(*args)
            self.pack_s.append(time.perf_counter() - t0)
            return out
        K._pack_part = staticmethod(timed_pack)

    def _timed(self, fn, kind, copy_stream=False):
        def run(kernel, *args):
            stream = (kernel._copy_stream if copy_stream
                      else torch.cuda.current_stream())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            out = fn(kernel, *args)
            b.record(stream)
            rows = args[1].shape[0] if kind == "dense" else 1
            self.spans[kind].append((a, b, rows))
            return out
        return run

    def per_contribution_us(self, kind):
        """Device us of ``kind`` (host us for ``"pack"``) over the
        contributions folded sparse."""
        torch.cuda.synchronize()
        rows = sum(r for _, _, r in self.spans["sparse"])
        if not rows:
            return float("nan")
        if kind == "pack":
            return 1e6 * sum(self.pack_s) / rows
        return 1e3 * sum(a.elapsed_time(b) for a, b, _ in self.spans[kind]
                         ) / rows

    def per_launch_us(self, kind):
        """Device us of ``kind`` per call."""
        torch.cuda.synchronize()
        spans = self.spans[kind]
        return (1e3 * sum(a.elapsed_time(b) for a, b, _ in spans)
                / len(spans) if spans else float("nan"))

    def close(self):
        for name, fn in self._orig.items():
            setattr(self.F.FoldKernel, name, fn)


def _host_fold(shapes, order, contributions, slices=None, weights=None):
    """The host fold (the parity oracle) of ``contributions``, each with
    its weight from ``weights`` where given (else its meta's)."""
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)

    host = StreamingFolder(shapes, order=order, slices=slices)
    for (meta, delta), w in zip(contributions,
                                weights or [None] * len(contributions)):
        host.add(meta, delta, w)
    host.finalize()
    return host


def _same_fold(a, b):
    from colearn_federated_learning_tpu_torch.utils import trees

    return a.total_w == b.total_w and all(
        x.tobytes() == y.tobytes() for x, y in
        zip(trees.leaves(a.wsum), trees.leaves(b.wsum)))


def socket_config(depth=None, **fed):
    """Config #4 as the main path runs it (flash, 4 local steps), with the
    socket plane's options; ``depth`` cuts BERT-base's 12 blocks (the
    width, 768, stays)."""
    base = main_path_config()
    run = {k: fed.pop(k) for k in list(fed)
           if k in ("fold_device", "comm_retries", "num_aggregators",
                    "agg_heartbeat_timeout", "agg_buffer_interval_s",
                    "trace_dir", "health_dir", "checkpoint_dir",
                    "ckpt_stream")}
    model = (base.model if depth is None
             else dataclasses.replace(base.model, depth=depth))
    return base.replace(model=model,
                        fed=dataclasses.replace(base.fed, **fed),
                        run=dataclasses.replace(base.run, **run))


def _federation(cfg, n_workers, want_evaluator, dataset, **async_kw):
    """(broker, workers, coordinator) on the card, enrolled; the caller
    stops them.  With ``async_kw`` the coordinator is the
    ``AsyncFederatedCoordinator`` built with them."""
    from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
        AsyncFederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker

    broker = MessageBroker().start()
    workers = []
    try:
        for i in range(n_workers):
            workers.append(DeviceWorker(cfg, i, broker.host, broker.port,
                                        dataset=dataset).start())
        if async_kw:
            coord = AsyncFederatedCoordinator(
                cfg, broker.host, broker.port,
                request_timeout=SOCKET_TIMEOUT,
                want_evaluator=want_evaluator, **async_kw)
        else:
            coord = FederatedCoordinator(cfg, broker.host, broker.port,
                                         round_timeout=SOCKET_TIMEOUT,
                                         want_evaluator=want_evaluator)
        coord.enroll(min_devices=n_workers, timeout=120.0)
    except BaseException:
        for w in workers:
            w.stop()
        broker.stop()
        raise
    return broker, workers, coord


def _stop(broker, workers, coord):
    coord.close()
    for w in workers:
        w.stop()
    broker.stop()


def socket_round_path(A, F, dataset, workdir):
    """11a: a broker, a FederatedCoordinator and 4 DeviceWorkers (3
    trainers and the evaluator) on the card, config #4 at 6 of BERT-base's
    12 blocks with topk8 uplinks,
    error feedback and the device fold, 2 rounds and an evaluation, with a
    trace and a health ledger, which 13b's checks read
    (``traced_socket_checks``); the live state is then saved as a
    streaming generation, which 16c restores."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.utils import trees

    trace_dir = os.path.join(workdir, "13b_trace")
    health_dir = os.path.join(workdir, "13b_health")
    cfg = socket_config(depth=CUT_DEPTH, compress="topk8",
                        compress_feedback=True, fold_device=True,
                        trace_dir=trace_dir, health_dir=health_dir,
                        checkpoint_dir=ckpt_dir("16c_sync"),
                        ckpt_stream=True)
    reg = telemetry.get_registry()
    reg.reset()
    t0 = time.perf_counter()
    rec_patch, timer = _Recorder(), None
    broker, workers, coord = _federation(cfg, 4, True, dataset)
    try:
        log(f"  [11a] {cfg.run.name}: bert width {cfg.model.width} "
            f"{cfg.model.dtype}, flash, topk8 + feedback, fold_device; "
            f"trainers {[d.device_id for d in coord.trainers]}, evaluator "
            f"{coord.evaluator.device_id}; cuts: {SOCKET_CUTS}; depth 12 "
            f"-> {CUT_DEPTH}; up in {time.perf_counter() - t0:.2f} s")
        if len(coord.trainers) != 3 or coord.evaluator is None:
            raise AssertionError("11a: roles not assigned as 3 + 1")
        trainers = sorted(d.device_id for d in coord.trainers)
        before = host_params(coord.params_tree())
        A.reset_launches()
        F.reset_launches()
        timer = _FoldTimer(F)
        records = []
        for _ in range(2):
            records.append(coord.run_round())
        t1 = time.perf_counter()
        ev = coord.evaluate()
        eval_s = time.perf_counter() - t1
        launches = {**A.launches, **F.launches}
        after = host_params(coord.params_tree())
        fold_us = timer.per_contribution_us("sparse")
        stage_us = timer.per_contribution_us("stage")
        trace_path = telemetry.write_tracer(trace_dir, cfg.run.name,
                                            coord.tracer,
                                            metrics=reg.snapshot())
        local_s = [sp.duration_s for sp in coord.tracer.snapshot()
                   if sp.name == "local_train"]
        # 16c: the live state saved as fit's last round saves it (this
        # path runs its rounds without fit).
        save_checkpoint_of(coord, "16c_sync", after)
    finally:
        if timer is not None:
            timer.close()
        rec_patch.close()
        _stop(broker, workers, coord)
    for r in records:
        log(f"  [11a] round {r['round']}: {r['round_time_s']:.3f} s, "
            f"train_loss {r['train_loss']:.6f}, completed {r['completed']}, "
            f"phase_broadcast_collect_s {r['phase_broadcast_collect_s']:.3f}"
            f", phase_aggregate_s {r['phase_aggregate_s']:.3f}, "
            f"phase_fold_overlap_s {r['phase_fold_overlap_s']:.3f}, "
            f"bytes_saved_uplink {r['bytes_saved_uplink']}")
        if not (r["completed"] == 3 and not r["dropped"]
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"11a: bad round record {r}")
    moved = sum(float(np.abs(a - b).sum()) for a, b in
                zip(trees.leaves(after), trees.leaves(before)))
    if not (moved > 0 and all(np.isfinite(a).all()
                              for a in trees.leaves(after))
            and math.isfinite(ev["eval_loss"])):
        raise AssertionError(f"11a: params moved {moved}, eval {ev}")
    # Round 0's updates folded again on the host: bitwise the device fold.
    dev = rec_patch.folders[0]
    if not _same_fold(dev, _host_fold(coord._shapes_np, dev.folded_ids,
                                      dev.received)):
        raise AssertionError("11a: the device fold differs from the host "
                             "fold of the same updates")
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    trained = 2 * 3 * steps
    eval_batches = math.ceil(len(dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    want = {"flash_forward": depth * (trained + eval_batches),
            "flash_backward_dq": depth * trained,
            "flash_backward_dkv": depth * trained,
            "fold_sparse": 2 * 3, "fold_dense": 0}
    if launches != want:
        raise AssertionError(f"11a: launches {launches}, expected {want}")
    log(f"  [11a] evaluate: loss {ev['eval_loss']:.6f} acc "
        f"{ev['eval_acc']:.4f} in {eval_s:.3f} s; params moved "
        f"{moved:.6e}; device fold == host fold of round 0 (bitwise); "
        f"fold_sparse {fold_us:.2f} us device per contribution, staging "
        f"copy {stage_us:.2f} us device per contribution; launches "
        f"{launches} (exact)")
    traced = traced_socket_checks(cfg, trainers, records, ev, trace_path,
                                  health_dir)
    traced["local_train_s_per_step"] = (sum(local_s) / len(local_s)
                                        / cfg.fed.local_steps)
    return (launches, [r["round_time_s"] for r in records], fold_us,
            stage_us, traced)


def check_recovery(tag, got, unmasked, survivors, masked):
    """Hold a recovered masked sum (``got``, its leaves) to the survivors'
    unmasked sum within CANCEL_ATOL, and the same sum with one survivor's
    delta lost, or doubled, to fail it (the smaller over the survivors), so
    the bound tells a wrong recovery from roundoff.  ``unmasked`` maps a
    survivor to its delta before the masks; ``masked`` are the masked
    deltas the folds summed, f32's spacing at whose largest entry is the
    size of one rounding of the masked sum.  Logs, then raises on either
    failure."""
    from colearn_federated_learning_tpu_torch.utils import trees

    parts = {c: [np.asarray(l, np.float32) for l in trees.leaves(unmasked[c])]
             for c in survivors}
    plain = [sum(leaves) for leaves in zip(*parts.values())]
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, plain))
    top = max(float(np.abs(b).max()) for b in plain)
    ulp = float(np.spacing(np.float32(max(
        float(np.abs(np.asarray(l, np.float32)).max())
        for delta in masked for l in trees.leaves(delta)))))
    planted = {"lost": math.inf, "doubled": math.inf}
    for part in parts.values():
        for name, sign in (("lost", -1), ("doubled", 1)):
            planted[name] = min(planted[name], max(
                float(np.abs(a - (b + sign * q)).max())
                for a, b, q in zip(got, plain, part)))
    log(f"  [{tag}] recovered sum vs the survivors' unmasked sum: max abs "
        f"diff {err:.3e} (bound {CANCEL_ATOL}; largest entry {top:.3e}, "
        f"relative {err / top:.3e}; f32 spacing at the largest masked entry "
        f"{ulp:.3e}, {err / ulp:.2f} of it); planted faults against the "
        f"same sum: one survivor's delta lost {planted['lost']:.3e}, "
        f"doubled {planted['doubled']:.3e}")
    if not err <= CANCEL_ATOL:
        raise AssertionError(f"{tag}: recovery error {err}")
    if not min(planted.values()) > CANCEL_ATOL:
        raise AssertionError(f"{tag}: a planted fault {planted} passes the "
                             f"bound {CANCEL_ATOL}")
    return err, planted


DROP_REPLY_2 = {"seed": 0, "faults": [
    {"kind": "corrupt_payload", "device_id": "2", "round": 0,
     "op": "train"}]}


def secure_socket_path(A, F, dataset):
    """11b: wire secure aggregation with DH keys and dropout recovery on
    BERT-base at 6 of its 12 blocks, 4 trainers, 1 round; a FaultPlan corrupts trainer 2's train
    reply after the share phase (transport retries off, so the reply is
    lost).  The round completes with the 3 others and the recovered
    aggregate equals their unmasked sum."""
    from colearn_federated_learning_tpu_torch import faults
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg = socket_config(depth=CUT_DEPTH, secure_agg=True, comm_retries=0)
    t0 = time.perf_counter()
    rec_patch = _Recorder(masks=True)
    broker, workers, coord = _federation(cfg, 4, False, dataset)
    try:
        A.reset_launches()
        F.reset_launches()
        faults.install(faults.FaultPlan.from_json(json.dumps(DROP_REPLY_2)))
        try:
            rec = coord.run_round()
        finally:
            faults.uninstall()
        launches = {**A.launches, **F.launches}
    finally:
        rec_patch.close()
        _stop(broker, workers, coord)
    if not (rec["completed"] == 3 and rec["dropped"] == ["2"]
            and rec["unmask_failed"] is False):
        raise AssertionError(f"11b: bad round record {rec}")
    folder = rec_patch.folders[0]
    survivors = [int(c) for c in folder.folded_ids]
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    want = {"flash_forward": depth * 4 * steps,
            "flash_backward_dq": depth * 4 * steps,
            "flash_backward_dkv": depth * 4 * steps,
            "fold_sparse": 0, "fold_dense": 0}
    log(f"  [11b] secure DH round, 4 trainers, trainer 2's reply lost: "
        f"survivors {survivors}, dropped {rec['dropped']}, unmask_failed "
        f"{rec['unmask_failed']}; round {rec['round_time_s']:.3f} s; "
        f"launches {launches}; path {time.perf_counter() - t0:.2f} s")
    if survivors != [0, 1, 3]:
        raise AssertionError(f"11b: survivors {survivors}")
    check_recovery("11b", trees.leaves(folder.wsum), rec_patch.unmasked,
                   survivors, [delta for _, delta in folder.received])
    if launches != want:
        raise AssertionError(f"11b: launches {launches}, expected {want}")
    return launches


SOCKET_CLI = ["--config", "cifar10_cnn_fedavg", "--num-clients", "3",
              "--rounds", "2"]
# Records kept from one phase for a later one's comparison (11c's rounds
# for 14c and 16b).
RECORDS: dict = {}
# The open process fleets by name ("cnn": 11c's, used by 12c, 14c and 16b);
# main() kills what a failed phase left.
FLEETS: dict = {}
CLI_MOD = [sys.executable, "-m", "colearn_federated_learning_tpu_torch.cli"]


class CliFleet:
    """``cli broker`` and 3 ``cli worker`` processes on the card (config
    #2's CNN, num_clients cut to 3; the workers take the ``worker``
    flags), and ``cli aggregator --fold-device`` processes added on
    demand.  The port's workers serve until they are stopped and enroll
    with each new coordinator, so several federations run their
    coordinators in turn against one fleet, each process started (and its
    CUDA context and dataset made) once."""

    def __init__(self, worker=()):
        # The children import the port from this checkout.
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=self.root + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.procs = []
        self.t0 = time.perf_counter()
        try:
            broker = self._spawn(["broker"], stdout=subprocess.PIPE,
                                 text=True)
            self.port = str(json.loads(broker.stdout.readline())["port"])
            for i in range(3):
                self._spawn(["worker", *SOCKET_CLI, *worker, "--client-id",
                             str(i), "--broker-port", self.port],
                            stdout=subprocess.DEVNULL)
        except BaseException:
            self.kill()
            raise
        self.aggregators = 0

    def _spawn(self, args, **kw):
        p = subprocess.Popen([*CLI_MOD, *args], env=self.env, cwd=self.root,
                             **kw)
        self.procs.append(p)
        return p

    def add_aggregators(self, n: int) -> None:
        for a in range(self.aggregators, self.aggregators + n):
            self._spawn(["aggregator", *SOCKET_CLI, "--agg-id", str(a),
                         "--broker-port", self.port, "--fold-device"],
                        stdout=subprocess.DEVNULL)
        self.aggregators += n

    def check_alive(self, tag: str) -> None:
        codes = [p.poll() for p in self.procs]
        if any(c is not None for c in codes):
            raise AssertionError(f"{tag}: a fleet process exited: {codes}")

    def close(self) -> list:
        """Stop every process with SIGTERM; their exit codes."""
        for p in self.procs:
            p.terminate()
        try:
            return [p.wait(60) for p in self.procs]
        finally:
            self.kill()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)


def cnn_fleet() -> CliFleet:
    """The fleet of 11c, 12c, 14c and 16b, started by the first of them."""
    if "cnn" not in FLEETS:
        FLEETS["cnn"] = CliFleet()
    return FLEETS["cnn"]


def cli_federation(F, fleet, aggregators=0, coordinate=(), live=None):
    """``cli coordinate --min-devices 3 --rounds 2 --fold-device
    --no-evaluator`` (with ``--num-aggregators`` when ``aggregators`` of
    the fleet's are asked for, and the ``coordinate`` flags) against
    ``fleet``, through
    ``cli.main`` in this process, which counts the fold kernel's launches;
    no evaluator, so all three workers train.  Every fleet process must
    still run after it.  Returns (every record of the coordinator, the
    global params on the host after each record's round or aggregation,
    the launches, seconds).  ``live(record, exporter)`` runs after each
    record while the coordinator (and its ``--metrics-port`` exporter, or
    None) is live."""
    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.comm import (
        async_coordinator, coordinator)
    from colearn_federated_learning_tpu_torch.comm.downlink import (
        host_params)
    from colearn_federated_learning_tpu_torch.telemetry import runtime

    t0 = time.perf_counter()
    if aggregators > fleet.aggregators:
        raise ValueError(f"the fleet has {fleet.aggregators} aggregators")
    tree = ["--num-aggregators", str(aggregators)] if aggregators else []
    F.reset_launches()
    records, params, exporters = [], [], []
    undo = []

    def start(self, _orig=runtime.MetricsExporter.start):
        exporters.append(self)
        return _orig(self)

    undo.append((runtime.MetricsExporter, "start",
                 runtime.MetricsExporter.start))
    runtime.MetricsExporter.start = start
    for cls, name in ((coordinator.FederatedCoordinator, "run_round"),
                      (async_coordinator.AsyncFederatedCoordinator,
                       "run_aggregation")):
        def kept(self, _orig=getattr(cls, name)):
            rec = _orig(self)
            records.append(rec)
            params.append(host_params(self.params_tree()))
            if live is not None:
                live(rec, exporters[-1] if exporters else None)
            return rec
        undo.append((cls, name, getattr(cls, name)))
        setattr(cls, name, kept)
    try:
        last = cli.main(["coordinate", *SOCKET_CLI, "--broker-port",
                         fleet.port, "--min-devices", "3", "--no-evaluator",
                         "--fold-device", *tree, *coordinate,
                         "--enroll-timeout", "300",
                         "--round-timeout", str(SOCKET_TIMEOUT)])
    finally:
        for cls, name, orig in undo:
            setattr(cls, name, orig)
    if not records or records[-1] is not last:
        raise AssertionError("the coordinator's last record is not the "
                             "one cli.main returned")
    fleet.check_alive("cli_federation")
    return records, params, dict(F.launches), time.perf_counter() - t0


CONV_KEYS = {"conv_update_norm", "conv_step_size", "conv_norm_ewma",
             "conv_trend"}        # JAX's; conv_cos_prev from the 2nd on
PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"(-?[0-9.]+([eE][-+]?[0-9]+)?|[-+]?Inf|NaN)$")


def _cli_exit(argv) -> tuple:
    """``cli.main(argv)`` in this process: (its exit status, its
    stdout)."""
    from colearn_federated_learning_tpu_torch import cli

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        code = 0
    except SystemExit as e:
        code = 0 if e.code is None else e.code
    return code, out.getvalue()


class ObservedCoordinator:
    """11c's and 14c's observability: ``coordinate --learn-observe
    --metrics-port 0 --events-file``.  While the coordinator is live
    (after its first record) ``cli top --once --url`` against its
    exporter (through ``cli.main`` in this process: a child process
    takes 9-10 s to import the package on the card machine) must exit 0
    with the round count and the learning section in its body, and
    ``/metrics`` must parse line by line as Prometheus text and hold
    ``learn_update_norm``; afterwards every record carries JAX's
    ``conv_*`` keys with the norm of the coordinator's own mean update,
    the events file holds a ``start`` line, a ``round`` line per record
    and a ``stop`` line, and ``cli converge`` over it exits 0."""

    def __init__(self, tag: str):
        self.tag = tag
        self.events = ckpt_dir(f"{tag}_events.jsonl")
        self.argv = ["--learn-observe", "--metrics-port", "0",
                     "--events-file", self.events]
        self.top = None

    def live(self, rec, exporter) -> None:
        if self.top is not None:
            return
        if exporter is None or exporter.port is None:
            raise AssertionError(f"{self.tag}: no live metrics exporter")
        base = f"http://127.0.0.1:{exporter.port}"
        t0 = time.perf_counter()
        code, body = _cli_exit(["top", "--once", "--url",
                                base + "/snapshot.json"])
        top_s = time.perf_counter() - t0
        if not (code == 0 and "rounds total" in body
                and "update norm" in body):
            raise AssertionError(f"{self.tag}: top exited {code}: {body}")
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        lines = [ln for ln in text.splitlines() if ln]
        bad = [ln for ln in lines if not (ln.startswith("# TYPE ")
                                          or PROM_SAMPLE.match(ln))]
        norm = [ln for ln in lines
                if ln.startswith("colearn_learn_update_norm ")]
        if bad or not norm:
            raise AssertionError(f"{self.tag}: /metrics lines {bad[:5]}, "
                                 f"learn_update_norm {norm}")
        self.top = (body, top_s, len(lines), norm[0])

    def check(self, records, folders) -> None:
        from colearn_federated_learning_tpu_torch.telemetry import convergence

        if self.top is None:
            raise AssertionError(f"{self.tag}: top never ran")
        for i, (rec, folder) in enumerate(zip(records, folders)):
            want = CONV_KEYS | ({"conv_cos_prev"} if i else set())
            norm = convergence.tree_norm(folder.mean()[0])
            if not (want <= set(rec) and math.isclose(
                    rec["conv_update_norm"], round(norm, 8), rel_tol=1e-5)):
                raise AssertionError(f"{self.tag}: record {i} "
                                     f"{ {k: rec.get(k) for k in want} }, "
                                     f"its mean's norm {norm}")
        with open(self.events) as f:
            kinds = [json.loads(line)["event"] for line in f]
        if kinds != ["start"] + ["round"] * len(records) + ["stop"]:
            raise AssertionError(f"{self.tag}: events {kinds}")
        t0 = time.perf_counter()
        code, conv = _cli_exit(["converge", self.events])
        if code != 0 or "trends:" not in conv:
            raise AssertionError(f"{self.tag}: converge exited {code}: "
                                 f"{conv}")
        body, top_s, n_lines, norm_line = self.top
        log(f"  [{self.tag}] --learn-observe: "
            + json.dumps([{k: r[k] for k in sorted(r)
                           if k.startswith("conv_")} for r in records]))
        log(f"  [{self.tag}] top --once exit 0 in {top_s:.2f} s; /metrics "
            f"{n_lines} lines parse, {norm_line!r}; events "
            f"{len(kinds)} lines (start, {len(records)} round, stop); "
            f"converge exit 0 in {time.perf_counter() - t0:.2f} s:")
        for line in body.splitlines() + conv.splitlines():
            log(f"  [{self.tag}]   {line}")


def socket_cli_path(F):
    """11c: ``cli coordinate --fold-device`` against the CNN fleet (the
    broker and 3 worker processes, started with phase 11 and shared with
    12c, 14c and 16b; ``cli_federation``): the fleet still runs after it
    (its
    processes exit 0 when 16b stops them), and ``fold_dense`` launches
    once per round on the coordinator.  Its records, params and folds are
    kept for 14c and 16b."""
    rec_patch = _Recorder()
    obs = ObservedCoordinator("11c")
    try:
        records, params, launches, took = cli_federation(
            F, cnn_fleet(), coordinate=obs.argv, live=obs.live)
    finally:
        rec_patch.close()
    obs.check(records, rec_patch.folders)
    RECORDS["11c"] = (records, params, rec_patch.folders)
    last = records[-1]
    log(f"  [11c] broker + 3 worker processes + coordinate ({SOCKET_CLI}, "
        f"cut: num_clients 100 -> 3): last record round {last['round']} "
        f"completed {last['completed']} train_loss {last['train_loss']:.6f}"
        f" in {last['round_time_s']:.3f} s; fold launches {launches}; "
        f"path {took:.2f} s")
    if not (last["round"] == 1 and last["completed"] == 3
            and math.isfinite(last["train_loss"])
            and launches["fold_dense"] == 2 and launches["fold_sparse"] == 0):
        raise AssertionError(f"11c: record {last}, launches {launches}")
    return launches


def socket_phase(A, F, _build):
    """Phase 11: the synchronous socket plane on the card (11a also runs
    13b's checks of the telemetry core)."""
    from colearn_federated_learning_tpu_torch.data import registry

    cfg = main_path_config()
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    paths, numbers = {}, {}
    # The CNN fleet of 11c, 12c, 14c and 16b starts first: its processes
    # make their CUDA contexts and draw CIFAR-10 while 11a and 11b run.
    cnn_fleet()
    t0 = time.perf_counter()
    # 11a's trace and ledger go to a temporary directory inside the
    # gitignored build directory, removed afterwards.
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        paths["socket_round"], numbers["11a_round_s"], \
            numbers["11a_fold_us"], numbers["11a_stage_us"], \
            numbers["13b"] = socket_round_path(A, F, dataset, workdir)
    log(f"  11a (with 13b's checks) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["socket_secure"] = secure_socket_path(A, F, dataset)
    log(f"  11b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["socket_cli"] = socket_cli_path(F)
    log(f"  11c in {time.perf_counter() - t0:.2f} s")
    log("phase 11 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 12
TREE_CUTS = ("local_steps 150 -> 4; 4 enrolled trainers (clients 0-3 of "
             "the 50-client partition), no evaluator; 2 aggregators")
# 12b, 14a and 14b run BERT-base at half its depth, to make room for 17c
# in the script's budget; the width and every check stay.
CUT_DEPTH = 6
MUD_FLEET = ((0, "camera"), (1, "camera"), (2, "bulb"), (3, "bulb"),
             (4, "thermostat"))


def _tree(cfg, broker, n):
    """``n`` AggregatorServers on ``broker``, each folding on the card
    when ``cfg`` asks for the device fold."""
    from colearn_federated_learning_tpu_torch.comm.aggregator import (
        AggregatorServer)

    aggs = []
    try:
        for a in range(n):
            aggs.append(AggregatorServer(cfg, a, broker.host,
                                         broker.port).start())
    except BaseException:
        for agg in aggs:
            agg.stop()
        raise
    return aggs


TREE_ROUNDS = 2           # 12a: a plain round, then one re-homing a slice


def tree_round_path(A, F, dataset, workdir):
    """12a: a broker, 4 trainer threads, 2 AggregatorServers with the
    device fold and the coordinator (num_aggregators 2, heartbeat timeout
    2 s, no evaluator) on config #4 at 6 of BERT-base's 12 blocks with
    topk8 uplinks and error feedback,
    ``TREE_ROUNDS`` rounds, with a trace and health ledgers (13c's checks
    run on round 0); aggregator 0 is stopped after round 0, so round 1
    re-homes its slice.  Each aggregator's partial is bitwise its host
    fold, and the root's sum is bitwise the host's slice-blocked fold of
    every contribution of the round; the launches are exact."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.comm.aggregator import (
        slice_cohort)

    trace_dir = os.path.join(workdir, "12a_trace")
    cfg = socket_config(depth=CUT_DEPTH, compress="topk8",
                        compress_feedback=True, fold_device=True,
                        num_aggregators=2, agg_heartbeat_timeout=2.0,
                        trace_dir=trace_dir,
                        health_dir=os.path.join(workdir, "12a_health"))
    reg = telemetry.get_registry()
    reg.reset()
    t0 = time.perf_counter()
    rec_patch, timer, aggs = _Recorder(), None, []
    broker, workers, coord = _federation(cfg, 4, False, dataset)
    try:
        aggs = _tree(cfg, broker, 2)
        enrolled = coord.enroll_aggregators(timeout=120.0)
        order = [d.device_id for d in coord.trainers]
        log(f"  [12a] {cfg.run.name}: bert width {cfg.model.width} "
            f"{cfg.model.dtype}, flash, topk8 + feedback, fold_device on "
            f"the aggregators and the root; trainers {order}, aggregators "
            f"{enrolled}; cuts: {TREE_CUTS}; depth 12 -> {CUT_DEPTH}; "
            f"{TREE_ROUNDS} rounds; up in "
            f"{time.perf_counter() - t0:.2f} s")
        A.reset_launches()
        F.reset_launches()
        timer = _FoldTimer(F)
        records = []
        for r in range(TREE_ROUNDS):
            records.append(coord.run_round())
            if r == 0:
                RECORDS["13c"] = traced_tree_checks(
                    cfg, list(coord.trainers), records[0],
                    {**A.launches, **F.launches},
                    telemetry.write_tracer(trace_dir, cfg.run.name,
                                           coord.tracer,
                                           metrics=reg.snapshot()))
                aggs[0].stop()          # its slice re-homes in round 1
        launches = {**A.launches, **F.launches}
        dense_us = timer.per_launch_us("dense")
    finally:
        if timer is not None:
            timer.close()
        rec_patch.close()
        for agg in aggs:
            agg.stop()
        _stop(broker, workers, coord)
    for r in records:
        log(f"  [12a] round {r['round']}: {r['round_time_s']:.3f} s, "
            f"train_loss {r['train_loss']:.6f}, completed {r['completed']}, "
            f"aggregators {r['aggregators']}, agg_failovers "
            f"{r.get('agg_failovers', 0)}, phase_broadcast_collect_s "
            f"{r['phase_broadcast_collect_s']:.3f}, phase_agg_fold_s "
            f"{r['phase_agg_fold_s']:.3f}, phase_aggregate_s "
            f"{r['phase_aggregate_s']:.3f}, phase_fold_overlap_s "
            f"{r['phase_fold_overlap_s']:.3f}")
        if not (r["aggregators"] == 2 and r["completed"] == 4
                and not r["dropped"] and math.isfinite(r["train_loss"])):
            raise AssertionError(f"12a: bad round record {r}")
    if "agg_failovers" in records[0] \
            or not records[1].get("agg_failovers", 0) >= 1:
        raise AssertionError(f"12a: failovers "
                             f"{[r.get('agg_failovers') for r in records]}")
    # Each aggregator's partial against its host fold; the root's sum per
    # round against the host's slice-blocked fold of the round's updates.
    if len(rec_patch.agg_folders) != 2 * TREE_ROUNDS \
            or len(rec_patch.folders) != TREE_ROUNDS:
        raise AssertionError(f"12a: {len(rec_patch.agg_folders)} slice "
                             f"folds, {len(rec_patch.folders)} root folds")
    by_round = {}
    for f in rec_patch.agg_folders:
        if not _same_fold(f, _host_fold(coord._shapes_np, f.folded_ids,
                                        f.received)):
            raise AssertionError("12a: an aggregator's device fold differs "
                                 "from its host fold")
        by_round.setdefault(int(f.received[0][0]["round"]), []).extend(
            f.received)
    for r, root in enumerate(rec_patch.folders):
        host = _host_fold(coord._shapes_np, order, by_round[r],
                          slice_cohort(order, 2))
        if len(by_round[r]) != 4 or not _same_fold(root, host):
            raise AssertionError(f"12a: round {r}'s root sum differs from "
                                 f"the slice-blocked host fold")
    # The slice folds are timed replayed on the card with nothing else
    # running: in the rounds, events on the stream the trainer threads
    # share would also enclose their kernels.  The root's fold_dense runs
    # after the collect, with the trainers idle, so it is timed in place.
    timer = _FoldTimer(F)
    try:
        for f in rec_patch.agg_folders:
            replay = _host_fold(coord._shapes_np, f.folded_ids, f.received)
            again = type(replay)(coord._shapes_np, order=f.folded_ids,
                                 device_fold=True)
            for meta, delta in f.received:
                again.add(meta, delta)
            again.finalize()
            if not _same_fold(again, replay):
                raise AssertionError("12a: a replayed slice fold differs")
        alone_us = timer.per_contribution_us("sparse")
        alone_stage_us = timer.per_contribution_us("stage")
    finally:
        timer.close()
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    trained = TREE_ROUNDS * 4 * steps
    want = {"flash_forward": depth * trained,
            "flash_backward_dq": depth * trained,
            "flash_backward_dkv": depth * trained,
            "fold_sparse": TREE_ROUNDS * 4, "fold_dense": TREE_ROUNDS}
    log(f"  [12a] every slice fold == its host fold, every root sum == the "
        f"slice-blocked host fold (bitwise, round 1's re-homed slice "
        f"included); the slice folds replayed alone: fold_sparse "
        f"{alone_us:.2f} us device, staging copy {alone_stage_us:.2f} us "
        f"per contribution; root fold_dense {dense_us:.2f} us device "
        f"per launch of 2 partials; launches {launches}; path "
        f"{time.perf_counter() - t0:.2f} s")
    if launches != want:
        raise AssertionError(f"12a: launches {launches}, expected {want}")
    return (launches, [r["round_time_s"] for r in records],
            [r["phase_agg_fold_s"] for r in records],
            {"fold_sparse_alone": alone_us, "stage_alone": alone_stage_us,
             "root_fold_dense": dense_us})


DROP_REPLY_3 = {"seed": 0, "faults": [
    {"kind": "corrupt_payload", "device_id": "3", "round": 0,
     "op": "train"}]}


def tree_secure_path(A, F, dataset):
    """12b: slice-local secure aggregation on BERT-base: 4 DH trainers in 2
    slices (0, 1 | 2, 3) behind 2 aggregators, dense uplinks, 1 round; a
    FaultPlan corrupts trainer 3's train reply after the share phase.
    Each slice runs its own recovery (DH removes the self-masks every
    round); only slice 1's rebuilds a lost member's pair masks."""
    from colearn_federated_learning_tpu_torch import faults
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg = socket_config(depth=CUT_DEPTH, secure_agg=True, comm_retries=0,
                        num_aggregators=2)
    t0 = time.perf_counter()
    rec_patch, aggs = _Recorder(masks=True), []
    broker, workers, coord = _federation(cfg, 4, False, dataset)
    recoveries = []
    recover = coord._recover_dh

    def traced(r, g_ids, g_recv, g_miss, folder, share_info):
        recoveries.append((list(g_ids), list(g_recv), list(g_miss)))
        return recover(r, g_ids, g_recv, g_miss, folder, share_info)

    coord._recover_dh = traced
    try:
        aggs = _tree(cfg, broker, 2)
        coord.enroll_aggregators(timeout=120.0)
        A.reset_launches()
        F.reset_launches()
        faults.install(faults.FaultPlan.from_json(json.dumps(DROP_REPLY_3)))
        try:
            rec = coord.run_round()
        finally:
            faults.uninstall()
        launches = {**A.launches, **F.launches}
    finally:
        rec_patch.close()
        for agg in aggs:
            agg.stop()
        _stop(broker, workers, coord)
    root = rec_patch.folders[0]
    survivors = sorted(int(c) for f in rec_patch.agg_folders
                       for c in f.folded_ids)
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    want = {"flash_forward": depth * 4 * steps,
            "flash_backward_dq": depth * 4 * steps,
            "flash_backward_dkv": depth * 4 * steps,
            "fold_sparse": 0, "fold_dense": 0}
    log(f"  [12b] secure DH tree round (depth {depth}), 4 trainers in 2 "
        f"slices, trainer 3's reply lost: completed {rec['completed']}, "
        f"dropped {rec['dropped']}, unmask_failed {rec['unmask_failed']}, "
        f"survivors {survivors}; recoveries (slice ids, folded, missing) "
        f"{recoveries}; round {rec['round_time_s']:.3f} s; launches "
        f"{launches}; path {time.perf_counter() - t0:.2f} s")
    if not (rec["completed"] == 3 and rec["dropped"] == ["3"]
            and rec["unmask_failed"] is False and rec["aggregators"] == 2
            and survivors == [0, 1, 2]):
        raise AssertionError(f"12b: bad round record {rec}")
    if sorted(recoveries) != [([0, 1], [0, 1], []), ([2, 3], [2], [3])]:
        raise AssertionError(f"12b: per-slice recoveries {recoveries}")
    check_recovery("12b", trees.leaves(root.wsum), rec_patch.unmasked,
                   survivors, [d for f in rec_patch.agg_folders
                               for _, d in f.received])
    if launches != want:
        raise AssertionError(f"12b: launches {launches}, expected {want}")
    return launches


def tree_cli_path(F):
    """12c: 2 ``cli aggregator --fold-device`` processes join the CNN
    fleet, and ``coordinate --num-aggregators 2 --rounds 1`` runs against
    it (``cli_federation``): the fleet still runs after it and the root's
    ``fold_dense`` launches once (one dense batch of the 2 partials)."""
    fleet = cnn_fleet()
    t0 = time.perf_counter()
    fleet.add_aggregators(2)
    records, _, launches, took = cli_federation(
        F, fleet, aggregators=2, coordinate=["--rounds", "1"])
    last = records[-1]
    log(f"  [12c] 2 aggregator processes join the fleet (broker + 3 worker "
        f"processes) + coordinate --num-aggregators 2 ({SOCKET_CLI}, cut: "
        f"num_clients 100 -> 3; 1 round): last record round "
        f"{last['round']} completed {last['completed']} aggregators "
        f"{last['aggregators']} "
        f"train_loss {last['train_loss']:.6f} in {last['round_time_s']:.3f}"
        f" s, phase_agg_fold_s {last['phase_agg_fold_s']:.3f}; root fold "
        f"launches {launches}; path {time.perf_counter() - t0:.2f} s "
        f"(coordinate {took:.2f} s)")
    if not (len(records) == 1 and last["round"] == 0
            and last["completed"] == 3 and last["aggregators"] == 2
            and math.isfinite(last["train_loss"])
            and launches == {"fold_sparse": 0, "fold_dense": 1}):
        raise AssertionError(f"12c: record {last}, launches {launches}")
    return launches


def mud_profile(device_type):
    return json.dumps({"ietf-mud:mud": {
        "mud-version": 1, "mud-url": f"https://mud.example/{device_type}",
        "is-supported": True, "systeminfo": f"a {device_type}",
        "mfg-name": "acme", "model-name": f"{device_type}-1",
        "colearn:device-type": device_type, "cache-validity": 24}})


def per_type_path(F):
    """12d: per-type federation on ``iot_traffic_tcn_fedavg`` (TCN width
    64, depth 4, bf16, at full width) with ``fold_device``: 5 worker
    threads announcing MUD profiles (camera, camera, bulb, bulb,
    thermostat), ``PerTypeFederation(min_devices_per_type=2)`` for 2
    rounds.  The cameras and the bulbs each train their own model; the
    lone thermostat is skipped; every type folds on the card."""
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.comm.per_type import (
        PerTypeFederation)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.data import registry
    from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    base = get_config("iot_traffic_tcn_fedavg")
    cfg = base.replace(run=dataclasses.replace(base.run, fold_device=True))
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    start = host_params(setup_lib.init_global_params(cfg, "cuda"))
    t0 = time.perf_counter()
    broker = MessageBroker().start()
    workers, fed = [], None
    try:
        for i, t in MUD_FLEET:
            workers.append(DeviceWorker(cfg, i, broker.host, broker.port,
                                        dataset=dataset,
                                        mud_profile=mud_profile(t)).start())
        fed = PerTypeFederation(cfg, broker.host, broker.port,
                                round_timeout=SOCKET_TIMEOUT,
                                min_devices_per_type=2)
        F.reset_launches()
        hists = fed.run(min_devices=len(MUD_FLEET), enroll_timeout=120.0,
                        rounds=2)
        launches = dict(F.launches)
        finals = {t: host_params(c.params_tree())
                  for t, c in fed.coordinators.items()}
        members = {t: sorted(d.device_id for d in c.trainers)
                   for t, c in fed.coordinators.items()}
    finally:
        if fed is not None:
            fed.close()
        for w in workers:
            w.stop()
        broker.stop()
    for t, hist in sorted(hists.items()):
        log(f"  [12d] {t}: trainers {members[t]}; rounds "
            + "; ".join(f"{r['round']}: completed {r['completed']} "
                        f"train_loss {r['train_loss']:.6f} "
                        f"{r['round_time_s']:.3f} s" for r in hist))
    log(f"  [12d] {cfg.run.name} (tcn width {cfg.model.width} depth "
        f"{cfg.model.depth} {cfg.model.dtype}): histories "
        f"{sorted(hists)}, skipped {fed.skipped}, errors {fed.errors}; "
        f"fold launches {launches}; path {time.perf_counter() - t0:.2f} s")
    if fed.errors or sorted(hists) != ["bulb", "camera"] \
            or fed.skipped != {"thermostat": 1}:
        raise AssertionError(f"12d: histories {sorted(hists)}, skipped "
                             f"{fed.skipped}, errors {fed.errors}")
    if members != {"camera": ["0", "1"], "bulb": ["2", "3"]} or not all(
            len(h) == 2 and all(r["completed"] == 2 and not r["dropped"]
                                and math.isfinite(r["train_loss"])
                                for r in h) for h in hists.values()):
        raise AssertionError(f"12d: members {members}, records {hists}")

    def flat(tree):
        return np.concatenate([np.ravel(np.asarray(l, np.float32))
                               for l in trees.leaves(tree)])

    cam, bulb, init = flat(finals["camera"]), flat(finals["bulb"]), flat(start)
    if not (np.isfinite(cam).all() and np.isfinite(bulb).all()
            and not np.array_equal(cam, init)
            and not np.array_equal(bulb, init)
            and not np.array_equal(cam, bulb)):
        raise AssertionError("12d: the type models are not finite, moved "
                             "and distinct")
    if launches != {"fold_sparse": 0, "fold_dense": 4}:
        raise AssertionError(f"12d: launches {launches}")
    return launches


def tree_phase(A, F):
    """Phase 12: the aggregator tree and per-type federation on the card
    (12a also runs 13c's checks of the telemetry core)."""
    from colearn_federated_learning_tpu_torch.data import registry
    from colearn_federated_learning_tpu_torch.ops import _build

    cfg = main_path_config()
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    paths, numbers = {}, {}
    t0 = time.perf_counter()
    # 12a's trace and ledgers go to a temporary directory inside the
    # gitignored build directory, removed afterwards.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        (paths["tree_round"], numbers["12a_round_s"],
         numbers["12a_agg_fold_s"], numbers["12a_fold_us"]) = \
            tree_round_path(A, F, dataset, workdir)
    log(f"  12a (with 13c's checks) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["tree_secure"] = tree_secure_path(A, F, dataset)
    log(f"  12b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["tree_cli"] = tree_cli_path(F)
    log(f"  12c in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["per_type"] = per_type_path(F)
    log(f"  12d in {time.perf_counter() - t0:.2f} s")
    log("phase 12 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 13
TRACE_WINDOW = 1           # 13a traces the first of its 2 rounds
# 13a and 16a at CUT_DEPTH of BERT-base's 12 blocks since PR 23.
BERT_TRACE = ["--config", BERT_HALF, "--attn-impl", "flash",
              "--local-steps", "4", "--rounds", "2", "--eval-every", "10"]
CLOCK_SLACK_S = 1e-3       # wall-clock anchors vs perf_counter durations


def bert_step_flops(cfg, seq_len: int, attention_factor: int = 18) -> int:
    """One BERT local step's FLOPs by hand: every Dense layer's matmul
    forward and its two backward products (the embeddings train, so
    every block's input gradient is formed), 6·N·(4·d² + 2·d·ff) per block
    over N = B·L tokens, the head's 6·B·d·C, and the attention core's
    ``attention_factor``·B·H·L²·D per block: the flash kernels' 4 + 6 + 8
    (the backward recomputes QKᵀ in K2 and K3)."""
    m, B, L = cfg.model, cfg.fed.batch_size, seq_len
    d, H = m.width, m.num_heads
    ff = 4 * d                       # the blocks' mlp_ratio
    N = B * L
    block = 6 * N * (4 * d * d + 2 * d * ff) \
        + attention_factor * B * H * L * L * (d // H)
    return m.depth * block + 6 * B * d * m.num_classes


FLASH_NAMES = ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
               "flash_dkv_bf16_kernel")
KERNEL_EVENT = re.compile(r'"cat": "kernel", "name": "([^"]*)"')


def _kernel_counts(names) -> dict:
    out: dict = {}
    for name in names:
        for k in FLASH_NAMES:
            if k in name:
                name = k
        out[name] = out.get(name, 0) + 1
    return out


def chrome_kernels(path: str) -> tuple[dict, float]:
    """Count the card's kernel events of a ``torch.profiler`` Chrome trace
    by kernel name (template arguments and signature dropped), by a scan
    of the text for kineto's ``"cat": "kernel", "name": ...`` (the same
    counts as loading the 236 MiB JSON, in a seventh of the time on the
    card machine); returns the counts and the seconds."""
    t0 = time.perf_counter()
    with open(path) as f:
        counts = _kernel_counts(KERNEL_EVENT.findall(f.read()))
    return counts, time.perf_counter() - t0


def traced_engine_path(A, workdir):
    """13a: ``train`` through ``cli.main`` on config #4 (BERT-base at 6 of
    its 12 blocks, flash, 4 local steps, 2 rounds) without and with ``--trace-dir
    --trace-rounds 1 --log-file --tensorboard-dir --profile-dir``, on the
    same plan: the record keys are the same but for the traced records'
    ``flops_per_round``, which equals the hand count (``bert_step_flops``
    × cohort 10 × 4 steps); the losses and params agree within phase
    10a's bound (expected 0.0: tracing adds no work to the round), the
    trace holds ``round``/``client_update``/``sync_metrics`` of round 0
    only, loads through the port's ``load_trace``, and its
    ``client_update`` durations are the records' ``phase_update_s``; the
    JSONL log holds the records.  The profiler window (rounds 1..2 of a
    2-round run: round 1 alone) writes one Chrome trace whose card events
    hold K2 and K3 once per layer and step of round 1 and K1 for those
    steps and round 1's evaluation batches.  K1-K3 launch exactly in both
    runs.  The untraced run saves its last round with
    ``--checkpoint-dir``: 16a's uninterrupted reference."""
    from colearn_federated_learning_tpu_torch import telemetry

    prof_dir = os.path.join(workdir, "13a_profile")
    trace_dir = os.path.join(workdir, "13a_trace")
    log_file = os.path.join(workdir, "13a_log.jsonl")
    tb_dir = os.path.join(workdir, "13a_tb")
    runs, paths = {}, {}
    for traced in (False, True):
        argv = list(BERT_TRACE)
        if traced:
            argv += ["--trace-dir", trace_dir, "--trace-rounds",
                     str(TRACE_WINDOW), "--log-file", log_file,
                     "--tensorboard-dir", tb_dir, "--profile-dir", prof_dir]
        else:
            # 16a's uninterrupted reference: its last round saves.
            argv += ["--checkpoint-dir", ckpt_dir("16a_straight")]
        label = "13a traced" if traced else "13a untraced"
        # The traced fit counts the round's FLOPs on one real local step
        # of one client (round_cost_analysis), which launches K1-K3 once.
        records, launches, learner = cli_path(
            A, label, argv, extra_steps=(lambda _: 1) if traced else None)
        runs[traced] = (records, [p.clone() for p in
                                  learner.params.values()],
                        learner.last_trace_path)
        paths["traced_engine" if traced else "untraced_engine"] = launches
        if traced:
            cfg = learner.config
            last_steps = int(learner.last_cohort["steps_run"].sum())
            seq_len = int(learner.x.shape[-1])
            flops_want = (bert_step_flops(cfg, seq_len)
                          * learner.cohort_size * learner.num_steps)
            eval_batches = math.ceil(len(learner.dataset.x_test)
                                     / max(cfg.fed.batch_size, 64))
        del learner
    (plain, p0, none_path), (recs, p1, path) = runs[False], runs[True]
    if none_path is not None or path is None:
        raise AssertionError(f"13a: trace paths {none_path}, {path}")
    # The untraced run's last record also carries its checkpoint's time;
    # the traced ones carry the round's FLOPs, as JAX's do.
    if [sorted(set(r) - {"flops_per_round"}) for r in recs] != [
            sorted(set(r) - {"phase_checkpoint_s"}) for r in plain]:
        raise AssertionError("13a: tracing changed the record keys")
    flops = [r.get("flops_per_round") for r in recs]
    if flops != [float(flops_want)] * len(recs):
        raise AssertionError(f"13a: flops_per_round {flops}, by hand "
                             f"{flops_want}")
    profiles = sorted(os.listdir(prof_dir))
    if len(profiles) != 1 or "_profile_rounds1-1_" not in profiles[0]:
        raise AssertionError(f"13a: profile files {profiles}")
    kern, t_load = chrome_kernels(os.path.join(prof_dir, profiles[0]))
    depth = cfg.model.depth
    evaluated = "eval_loss" in recs[-1]
    prof_want = {"flash_fwd_bf16_kernel": depth * (
                     last_steps + (eval_batches if evaluated else 0)),
                 "flash_dq_bf16_kernel": depth * last_steps,
                 "flash_dkv_bf16_kernel": depth * last_steps}
    prof_got = {k: kern.get(k, 0) for k in prof_want}
    if prof_got != prof_want:
        raise AssertionError(f"13a: profiled card kernels {prof_got}, "
                             f"expected round 1's {prof_want}")
    log(f"  [13a] flops_per_round {flops[0]:.6e} (by hand: "
        f"{bert_step_flops(cfg, seq_len):.6e} per step x cohort 10 x 4 "
        f"steps); "
        f"profile {profiles[0]} "
        f"({os.path.getsize(os.path.join(prof_dir, profiles[0])) / 2**20:.1f}"
        f" MiB, scanned in {t_load:.2f} s): flash kernels {prof_got} (round 1 "
        f"only), {sum(kern.values())} card kernel events of "
        f"{len(kern)} names")
    loss_diff = max(abs(a["train_loss"] - b["train_loss"])
                    for a, b in zip(recs, plain))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
    bound = max(REMAT_ATOL + REMAT_RTOL * float(a.abs().max()) for a in p0)
    if not (loss_diff <= REMAT_ATOL + REMAT_RTOL * max(
            abs(r["train_loss"]) for r in plain) and param_diff <= bound):
        raise AssertionError(f"13a: tracing changed the round: loss "
                             f"{loss_diff}, params {param_diff}")
    doc = telemetry.load_trace(path)
    spans = telemetry.trace_spans(doc)
    by_round = {}
    for sp in spans:
        if "round" in sp.attrs:
            by_round.setdefault(int(sp.attrs["round"]), []).append(sp.name)
    want = {r: ["client_update", "round", "sync_metrics"]
            for r in range(TRACE_WINDOW)}
    if {r: sorted(n) for r, n in by_round.items()} != want:
        raise AssertionError(f"13a: traced spans by round {by_round}")
    for sp in spans:
        if sp.name == "client_update":
            got = recs[int(sp.attrs["round"])]["phase_update_s"]
            if abs(sp.duration_s - got) > 1e-6:
                raise AssertionError(f"13a: client_update {sp.duration_s} "
                                     f"s, phase_update_s {got} s")
    with open(log_file) as f:
        logged = [json.loads(line) for line in f]
    if [{k: v for k, v in r.items() if k not in ("name", "ts")}
            for r in logged] != json.loads(json.dumps(recs)):
        raise AssertionError("13a: the JSONL log differs from the records")
    tb = (sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir)
          else "not written (no tensorboard package: the mirror is off)")
    # The registry's snapshot closes the summary: that of every phase.
    for line in telemetry.summarize_trace(doc).split(
            "\nmetrics:")[0].splitlines():
        log(f"  [13a] {line}")
    traced_s = [r["round_time_s"] for r in recs]
    plain_s = [r["round_time_s"] for r in plain]
    log(f"  [13a] s/round traced {[round(t, 4) for t in traced_s]}, "
        f"untraced {[round(t, 4) for t in plain_s]}; loss diff "
        f"{loss_diff:.3e}, params max abs diff {param_diff:.3e} (bound "
        f"{REMAT_RTOL:g} rel / {REMAT_ATOL:g} abs); client_update == "
        f"phase_update_s; {len(logged)} JSONL lines; tensorboard {tb}; "
        f"{card()}")
    return paths, {"traced_round_s": traced_s, "untraced_round_s": plain_s}


def _contains(outer, inner) -> bool:
    return (inner.t_wall >= outer.t_wall - CLOCK_SLACK_S
            and inner.t_wall + inner.duration_s
            <= outer.t_wall + outer.duration_s + CLOCK_SLACK_S)


def collect_split(spans):
    """Per round of a flat socket trace: ``broadcast_collect``'s seconds,
    and its slowest trainer's ``worker.train`` split into
    ``deserialize_params``, ``local_train`` and ``compress_delta``, with
    the rest of the collect (frames, decode, fold, the other trainers'
    wait) beside them.  Checks the spans' nesting."""
    rounds = {sp.span_id: sp for sp in spans if sp.name == "round"}
    split = []
    for rid, rnd in sorted(rounds.items(), key=lambda kv: kv[1].t_wall):
        collect = [sp for sp in spans if sp.name == "broadcast_collect"
                   and sp.parent_id == rid]
        trains = [sp for sp in spans if sp.name == "worker.train"
                  and sp.parent_id == rid]
        if len(collect) != 1 or not trains or not all(
                _contains(collect[0], t) for t in trains):
            raise AssertionError(f"13b: round {rnd.attrs}: collect "
                                 f"{len(collect)}, trains {len(trains)}, "
                                 "or a train outside the collect")
        slow = max(trains, key=lambda t: t.duration_s)
        parts = {sp.name: sp.duration_s for sp in spans
                 if sp.parent_id == slow.span_id}
        if not {"deserialize_params", "local_train",
                "compress_delta"} <= set(parts):
            raise AssertionError(f"13b: worker.train children {parts}")
        split.append({
            "round": rnd.attrs.get("round"),
            "broadcast_collect_s": collect[0].duration_s,
            "slowest": slow.attrs.get("client_id"),
            "worker_train_s": slow.duration_s,
            **{f"{k}_s": parts[k] for k in ("deserialize_params",
                                            "local_train", "compress_delta")},
            "rest_s": collect[0].duration_s - slow.duration_s})
    return split


def traced_socket_checks(cfg, trainers, records, ev, path, health_dir):
    """13b, on 11a's federation (3 trainers and the evaluator, topk8 with
    feedback, the device fold, a trace and a health ledger, 2 rounds and an
    evaluation): the trace file loads, its collect holds each trainer's
    adopted ``worker.train`` with ``local_train`` and ``compress_delta``
    inside, the ledger has the 3 trainers, the records carry the
    ``health_*`` keys, ``fed.rounds_total`` is 2 and every frame sent in
    the process was received.  Prints the collect's split per round."""
    from colearn_federated_learning_tpu_torch import telemetry

    reg = telemetry.get_registry()
    # A sender counts a frame once its write returned, which may be after
    # the receiver counted it: wait (bounded) for the last ones.
    deadline = time.monotonic() + 10.0
    snap = reg.snapshot()
    while (snap["comm.messages_sent"] != snap["comm.messages_received"]
           and time.monotonic() < deadline):
        time.sleep(0.01)
        snap = reg.snapshot()
    fleet = telemetry.load_health(health_dir)
    if sorted(fleet) != trainers or any(h.rounds != 2
                                        for h in fleet.values()):
        raise AssertionError(f"13b: ledger {sorted(fleet)} vs trainers "
                             f"{trainers}")
    for r in records:
        if not (r["completed"] == 3 and r["health_devices"] == 3
                and r["health_lat_p99_s"] > 0
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"13b: bad round record {r}")
    if not (snap["fed.rounds_total"] == 2 and snap["comm.messages_sent"]
            == snap["comm.messages_received"] > 0
            and math.isfinite(ev["eval_loss"])):
        raise AssertionError(f"13b: rounds {snap.get('fed.rounds_total')}, "
                             f"messages {snap.get('comm.messages_sent')} "
                             f"sent, {snap.get('comm.messages_received')} "
                             "received")
    doc = telemetry.load_trace(path)
    split = collect_split(telemetry.trace_spans(doc))
    summary = telemetry.summarize_trace(doc)
    for line in summary.split("\nmetrics:")[0].splitlines():
        log(f"  [13b] {line}")
    for sp in split:
        log("  [13b] collect split " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in sp.items()}))
    mean = {k: sum(sp[k] for sp in split) / len(split)
            for k in ("broadcast_collect_s", "deserialize_params_s",
                      "local_train_s", "compress_delta_s", "rest_s")}
    log(f"  [13b] rounds {[round(r['round_time_s'], 3) for r in records]} "
        f"s; ledger {sorted(fleet)} (lat ewma "
        f"{[round(fleet[d].lat_ewma, 3) for d in sorted(fleet)]} s); "
        f"messages {snap['comm.messages_sent']:.0f} sent = received; "
        f"bytes {snap['comm.bytes_sent']:.0f}; launches as 11a's; "
        f"{card()}")
    return {"split": split, "mean": mean,
            "round_s": [r["round_time_s"] for r in records]}


def traced_tree_checks(cfg, trainers, rec, launches, path) -> dict:
    """13c, on 12a's federation: its round 0 (4 trainers, 2 aggregator
    threads, the device fold, no failover yet) with a trace and health
    ledgers: the tier's ``aggregator.fold`` spans
    parent onto the root's round (the root's fold requests carried its
    context) and the trainers' spans onto them; ``fold_sparse`` and
    ``fold_dense`` launch as in a 12a round; the ledgers hold the 4
    trainers with their aggregator, and ranked by their latency
    ``assign_slices`` puts the slowest in the last slice.  ``path`` is the
    trace written after round 0."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.comm.aggregator import (
        assign_slices)

    depth, steps = cfg.model.depth, cfg.fed.local_steps
    want = {"flash_forward": depth * 4 * steps,
            "flash_backward_dq": depth * 4 * steps,
            "flash_backward_dkv": depth * 4 * steps,
            "fold_sparse": 4, "fold_dense": 1}
    if launches != want:
        raise AssertionError(f"13c: launches {launches}, expected {want}")
    if not (rec["completed"] == 4 and rec["health_devices"] == 4
            and math.isfinite(rec["train_loss"])):
        raise AssertionError(f"13c: bad round record {rec}")
    spans = telemetry.trace_spans(telemetry.load_trace(path))
    by_id = {sp.span_id: sp for sp in spans}
    rnd = [sp for sp in spans if sp.name == "round"]
    folds = [sp for sp in spans if sp.name == "aggregator.fold"]
    trains = [sp for sp in spans if sp.name == "worker.train"]
    collect = [sp for sp in spans if sp.name == "broadcast_collect"]
    if not (len(rnd) == 1 and len(folds) == 2 and len(trains) == 4
            and len(collect) == 1
            and all(f.parent_id == rnd[0].span_id for f in folds)
            and all(by_id[t.parent_id].name == "aggregator.fold"
                    for t in trains)
            and {f.process for f in folds} == {"aggregator-0",
                                               "aggregator-1"}):
        raise AssertionError(
            f"13c: spans {[(s.name, s.process) for s in spans]}")
    fleet = telemetry.load_health(cfg.run.health_dir)
    ids = sorted(d.device_id for d in trainers)
    if sorted(fleet) != ids or {h.agg for h in fleet.values()} != {"0", "1"}:
        raise AssertionError(
            f"13c: ledgers {[(d, h.agg) for d, h in fleet.items()]}")
    lat = {d: h.lat_ewma for d, h in fleet.items()}
    ranked = assign_slices(trainers, 2, scores=lat)
    slowest = max(lat, key=lat.get)
    if ranked[-1][-1].device_id != slowest:
        raise AssertionError(f"13c: slices {ranked} by latency {lat}")
    fold_s = sorted(f.duration_s for f in folds)
    log(f"  [13c] 12a's round 0 {rec['round_time_s']:.3f} s: "
        f"broadcast_collect {collect[0].duration_s:.3f} s, the tier's "
        f"aggregator.fold {[round(t, 3) for t in fold_s]} s "
        f"(phase_agg_fold_s {rec['phase_agg_fold_s']:.3f}); each fold "
        f"span's parent is the root's round, each worker.train's a fold "
        f"span; ledgers { {d: fleet[d].agg for d in ids} }; by latency "
        f"{ {d: round(v, 3) for d, v in lat.items()} } the slices are "
        f"{[[d.device_id for d in sl] for sl in ranked]}; launches "
        f"{launches} (exact); {card()}")
    return {"round_s": rec["round_time_s"], "collect_s": collect[0].duration_s,
            "agg_fold_s": fold_s}


def telemetry_phase(A, F, _build):
    """Phase 13: the telemetry core on the card, on config #4."""
    from colearn_federated_learning_tpu_torch.data import registry

    cfg = main_path_config()
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    paths, numbers = {}, {}
    # Traces, logs and ledgers go to a temporary directory inside the
    # gitignored build directory, removed afterwards.
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        t0 = time.perf_counter()
        engine_paths, numbers["13a"] = traced_engine_path(A, workdir)
        paths.update(engine_paths)
        log(f"  13a in {time.perf_counter() - t0:.2f} s")
    numbers["13c"] = RECORDS["13c"]      # run on 12a's federation
    log("phase 13 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 14
ASYNC_CUTS = ("local_steps 150 -> 4; depth 12 -> 6; 4 enrolled trainers "
              "(clients 0-3 of the 50-client partition)")
ASYNC_K = 2                # 14a's buffer: K = 2 of 4 trainers
ASYNC_AGGS = 4             # 14a's aggregations (0 warms up; cut from 6)
TREE_ASYNC_AGGS = 4        # 14b's; aggregator 0 stops after aggregation 1
BASE_KEYS = {"aggregation", "model_version", "buffer_size", "staleness_mean",
             "staleness_max", "discarded", "contributors", "train_loss",
             "total_weight", "agg_time_s", "phase_collect_s",
             "phase_apply_s"}
OBSERVE_KEYS = {"mass_folded", "mass_discarded", "arrival_rate_per_s",
                "staleness_p50", "staleness_p90", "staleness_p99"}
TREE_KEYS = {"agg_id", "agg_buffer_k", "agg_buffer_rate_per_s",
             "oldest_version", "folded_keys", "agg_failovers",
             "rehomed_devices", "rehomed_total"}


def _async_launches_want(cfg, dispatches, eval_batches=0, fold_sparse=0,
                         fold_dense=0):
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    return {"flash_forward": depth * (steps * dispatches + eval_batches),
            "flash_backward_dq": depth * steps * dispatches,
            "flash_backward_dkv": depth * steps * dispatches,
            "fold_sparse": fold_sparse, "fold_dense": fold_dense}


def flat_async_path(A, F, dataset, workdir):
    """14a: a broker, 4 trainer threads and the evaluator, and the
    ``AsyncFederatedCoordinator`` (K = 2, ``observe``, a trace and a
    health ledger) on config #4 with topk8 uplinks, error feedback and the
    device fold: 4 aggregations and an evaluation; the live state is then
    saved as a streaming generation, which 16c restores."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg = socket_config(depth=CUT_DEPTH, compress="topk8",
                        compress_feedback=True, fold_device=True,
                        trace_dir=os.path.join(workdir, "14a_trace"),
                        health_dir=os.path.join(workdir, "14a_health"),
                        checkpoint_dir=ckpt_dir("16c_async"),
                        ckpt_stream=True)
    t0 = time.perf_counter()
    rec_patch = _Recorder()
    broker, workers, coord = _federation(cfg, 5, True, dataset,
                                         buffer_size=ASYNC_K, observe=True)
    try:
        log(f"  [14a] {cfg.run.name}: bert width {cfg.model.width} "
            f"{cfg.model.dtype}, flash, topk8 + feedback, fold_device; "
            f"trainers {[d.device_id for d in coord.trainers]}, evaluator "
            f"{coord.evaluator.device_id}; K = {ASYNC_K}; cuts: "
            f"{ASYNC_CUTS}; up in {time.perf_counter() - t0:.2f} s")
        if len(coord.trainers) != 4 or coord.evaluator is None:
            raise AssertionError("14a: roles not assigned as 4 + 1")
        before = host_params(coord.params_tree())
        A.reset_launches()
        F.reset_launches()
        records = [coord.run_aggregation() for _ in range(ASYNC_AGGS)]
        t1 = time.perf_counter()
        ev = coord.evaluate()
        eval_s = time.perf_counter() - t1
        after = host_params(coord.params_tree())
        t1 = time.perf_counter()
        save_checkpoint_of(coord, "16c_async", after)
        CKPT["16c_async"]["version"] = coord.version
        CKPT["16c_async"]["path_s"] = time.perf_counter() - t1
        # Closing joins the pumps: every dispatch in flight ends, and its
        # training is in the launch counts.
        coord.close()
        torch.cuda.synchronize()
        launches = {**A.launches, **F.launches}
        spans = coord.tracer.snapshot()
        path = telemetry.write_tracer(cfg.run.trace_dir, cfg.run.name,
                                      coord.tracer)
    finally:
        rec_patch.close()
        _stop(broker, workers, coord)
    for r in records:
        keys = set(r)
        if not (BASE_KEYS | OBSERVE_KEYS | {"health_devices"} <= keys
                and all(k.startswith("health_") for k in keys - BASE_KEYS
                        - OBSERVE_KEYS)):
            raise AssertionError(f"14a: record keys {sorted(keys)}")
        log(f"  [14a] aggregation {r['aggregation']}: agg_time_s "
            f"{r['agg_time_s']:.3f}, phase_collect_s "
            f"{r['phase_collect_s']:.3f}, phase_apply_s "
            f"{r['phase_apply_s']:.3f}, staleness mean "
            f"{r['staleness_mean']:.3f} max {r['staleness_max']} p90 "
            f"{r['staleness_p90']}, arrival_rate_per_s "
            f"{r['arrival_rate_per_s']:.4f}, discarded {r['discarded']}, "
            f"contributors {r['contributors']}, train_loss "
            f"{r['train_loss']:.6f}")
    if [r["model_version"] for r in records] != list(
            range(1, ASYNC_AGGS + 1)):
        raise AssertionError("14a: model versions "
                             f"{[r['model_version'] for r in records]}")
    for r in records:
        if not (len(r["contributors"]) == ASYNC_K
                and r["staleness_max"] <= coord.max_staleness
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"14a: bad record {r}")
    moved = sum(float(np.abs(a - b).sum()) for a, b in
                zip(trees.leaves(after), trees.leaves(before)))
    if not (moved > 0 and all(np.isfinite(a).all()
                              for a in trees.leaves(after))
            and math.isfinite(ev["eval_loss"])):
        raise AssertionError(f"14a: params moved {moved}, eval {ev}")
    # Aggregation 0's staged contributions, folded again on the host.
    dev = rec_patch.folders[0]
    if not _same_fold(dev, _host_fold(dev.shapes, None, dev.received,
                                      weights=dev.weights)):
        raise AssertionError("14a: the device fold differs from the host "
                             "fold of the same contributions")
    # Every fold_update parents onto its dispatch_train.
    dispatch = {sp.span_id: sp for sp in spans
                if sp.name == "dispatch_train"}
    folds = [sp for sp in spans if sp.name == "fold_update"]
    orphans = [sp.attrs for sp in folds
               if sp.parent_id not in dispatch
               or dispatch[sp.parent_id].trace_id != sp.trace_id
               or dispatch[sp.parent_id].attrs["device"]
               != sp.attrs["device"]]
    folded = sum(len(r["contributors"]) for r in records)
    if orphans or len(folds) != folded + sum(r["discarded"]
                                             for r in records):
        raise AssertionError(f"14a: {len(folds)} fold_update spans, "
                             f"orphans {orphans}")
    if coord.failures:
        raise AssertionError(f"14a: failed dispatches {coord.failures}")
    eval_batches = math.ceil(len(dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    want = _async_launches_want(cfg, len(dispatch), eval_batches,
                                fold_sparse=folded)
    if launches != want:
        raise AssertionError(f"14a: launches {launches}, expected {want} "
                             f"({len(dispatch)} dispatches)")
    warm = records[1:]
    rate = len(warm) / sum(r["agg_time_s"] for r in warm)
    taus = [r["staleness_mean"] for r in warm]
    log(f"  [14a] evaluate: loss {ev['eval_loss']:.6f} acc "
        f"{ev['eval_acc']:.4f} in {eval_s:.3f} s; params moved "
        f"{moved:.6e}; {len(dispatch)} dispatches, {folded} folded; "
        f"device fold == host fold of aggregation 0 (bitwise); every "
        f"fold_update parents onto its dispatch_train; {rate:.4f} "
        f"aggregations/s over aggregations 1-{ASYNC_AGGS - 1}, mean tau "
        f"{sum(taus) / len(taus):.3f}; trace {os.path.basename(path)}; "
        f"launches {launches} (exact); path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    return launches, {
        "agg_time_s": [r["agg_time_s"] for r in records],
        "phase_collect_s": [r["phase_collect_s"] for r in records],
        "phase_apply_s": [r["phase_apply_s"] for r in records],
        "staleness_mean": [r["staleness_mean"] for r in records],
        "staleness_max": [r["staleness_max"] for r in records],
        "staleness_p90": [r["staleness_p90"] for r in records],
        "arrival_rate_per_s": [r["arrival_rate_per_s"] for r in records],
        "discarded": [r["discarded"] for r in records],
        "aggregations_per_s_warm": rate, "dispatches": len(dispatch)}


def _die_at_next_abuf(agg):
    """Make ``agg`` stop as the next contribution reaches it (an
    aggregator that dies mid-staging): the pump's request fails and the
    contribution falls back to a live sibling."""
    handle = agg._handle

    def handler(header, tree):
        if header.get("op") == "abuf":
            agg._server._handler = handle
            agg.stop()
            raise ConnectionError(f"aggregator {agg.agg_id} stopped")
        return handle(header, tree)

    agg._server._handler = handler


def tree_async_path(A, F, dataset):
    """14b: 14a's config through the tree: 4 trainer threads, 2
    ``AggregatorServer`` threads with the device fold, ``num_aggregators``
    2, ``agg_buffer_interval_s`` 2.0, heartbeat timeout 2 s, no
    evaluator; 4 aggregations.  After aggregation 1, aggregator 0 stops as
    the next contribution reaches it; the next aggregation starts once
    that contribution has failed over to aggregator 1."""
    cfg = socket_config(depth=CUT_DEPTH, compress="topk8",
                        compress_feedback=True, fold_device=True,
                        num_aggregators=2, agg_buffer_interval_s=2.0,
                        agg_heartbeat_timeout=2.0)
    t0 = time.perf_counter()
    rec_patch, aggs = _Recorder(), []
    broker, workers, coord = _federation(cfg, 4, False, dataset,
                                         buffer_size=ASYNC_K)
    consumed = []                  # every partial the root took
    take = coord._partials.get

    def kept_get(*args, **kw):
        item = take(*args, **kw)
        consumed.append(item[0])
        return item

    coord._partials.get = kept_get
    try:
        aggs = _tree(cfg, broker, 2)
        enrolled = coord.enroll_aggregators(timeout=120.0)
        log(f"  [14b] {cfg.run.name}: trainers "
            f"{[d.device_id for d in coord.trainers]}, aggregators "
            f"{enrolled}, slices {coord._assign}; interval "
            f"{cfg.run.agg_buffer_interval_s} s; cuts: {ASYNC_CUTS}, no "
            f"evaluator; up in {time.perf_counter() - t0:.2f} s")
        A.reset_launches()
        F.reset_launches()
        records = []
        for i in range(TREE_ASYNC_AGGS):
            records.append(coord.run_aggregation())
            if i == 1:
                _die_at_next_abuf(aggs[0])
                deadline = time.monotonic() + SOCKET_TIMEOUT
                while (not coord._failovers_pending
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
        coord.close()
        for agg in aggs:
            agg.stop()
        torch.cuda.synchronize()
        launches = {**A.launches, **F.launches}
        spans = [sp for sp in coord.tracer.snapshot()
                 if sp.name == "dispatch_train"]
        # Drained but not taken (read in place: a get would count them
        # as taken).
        queued = [item[0] for item in list(coord._partials.queue)]
        inflight = set(coord._inflight)
    finally:
        rec_patch.close()
        for agg in aggs:
            agg.stop()
        _stop(broker, workers, coord)
    for r in records:
        log(f"  [14b] aggregation {r['aggregation']}: agg {r['agg_id']} "
            f"keys {r['folded_keys']}, agg_buffer_k {r['agg_buffer_k']}, "
            f"oldest_version {r['oldest_version']}, staleness max "
            f"{r['staleness_max']}, discarded {r['discarded']}, "
            f"agg_failovers {r['agg_failovers']}, rehomed "
            f"{r['rehomed_devices']}, agg_time_s {r['agg_time_s']:.3f}, "
            f"phase_collect_s {r['phase_collect_s']:.3f} (the root waiting "
            f"on the tier: {r['phase_collect_s'] / r['agg_time_s']:.1%}), "
            f"phase_apply_s {r['phase_apply_s']:.3f}, train_loss "
            f"{r['train_loss']:.6f}")
        if not (TREE_KEYS | BASE_KEYS <= set(r)
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"14b: bad record {r}")
    if not any(r["agg_failovers"] for r in records):
        raise AssertionError("14b: no record carries a failover")
    # Every drained partial against the host fold of its keys (a stopped
    # aggregator's last drain included: its thread outlives the stop,
    # though its reply never reaches the root).
    drained = [f for f in rec_patch.agg_folders if f._finalized]
    for f in drained:
        if not _same_fold(f, _host_fold(f.shapes, f.folded_ids,
                                        f.received)):
            raise AssertionError("14b: a drained partial differs from the "
                                 "host fold of its keys")
    # Every dispatched contribution folded once: drained exactly once
    # (applied or discarded), queued at the root, or still in flight.
    dispatched = sorted(f"{sp.attrs['version']:08d}@{sp.attrs['device']}"
                        for sp in spans)
    taken = [k for m in consumed + queued for k in m["keys"]]
    if coord.failures or len(taken) != len(set(taken)) \
            or set(taken) & inflight \
            or sorted(set(taken) | inflight) != dispatched:
        raise AssertionError(f"14b: dispatched {dispatched}, drained "
                             f"{taken}, in flight {sorted(inflight)}, "
                             f"failures {coord.failures}")
    staged = sum(len(f.folded_ids) for f in drained)
    applied = sum(1 for r in records if not r.get("skipped_quorum"))
    want = _async_launches_want(cfg, len(spans), fold_sparse=staged,
                                fold_dense=applied)
    if launches != want:
        raise AssertionError(f"14b: launches {launches}, expected {want}")
    parts = [{"agg": m["agg_id"], "count": m["count"],
              "buffer_k": m["buffer_k"], "dedup": m["dedup"],
              "rehomed": m["rehomed"], "fold_s": round(m["fold_s"], 4)}
             for m in consumed]
    finals = [round(f.finalize_s, 4) for f in drained]
    log(f"  [14b] partials taken by the root {parts}; the drains' "
        f"finalize (device fold and copy back) {finals} s; "
        f"{len(spans)} dispatches, {len(taken)} drained once, "
        f"{len(inflight)} in flight at the end; every drained partial == "
        f"the host fold of its keys (bitwise); launches {launches} "
        f"(exact); path {time.perf_counter() - t0:.2f} s; {card()}")
    return launches, {
        "agg_time_s": [r["agg_time_s"] for r in records],
        "phase_collect_s": [r["phase_collect_s"] for r in records],
        "phase_apply_s": [r["phase_apply_s"] for r in records],
        "buffer_k": [m["buffer_k"] for m in consumed],
        "fold_s": [m["fold_s"] for m in consumed],
        "finalize_s": finals,
        "failovers": [r["agg_failovers"] for r in records]}


def _by_device(folder):
    """A coordinator fold's updates by device id (the async staging keys
    are ``f"{idx:08d}@{dev}"``)."""
    return {str(m["client_id"]).split("@")[-1]: d for m, d in folder.received}


def _leaves_equal(a, b) -> bool:
    from colearn_federated_learning_tpu_torch.utils import trees

    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(trees.leaves(a), trees.leaves(b)))


def _max_abs_diff(a, b) -> float:
    from colearn_federated_learning_tpu_torch.utils import trees

    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(trees.leaves(a), trees.leaves(b)))


def _close_f32(a, b) -> bool:
    """Every leaf within f32 rtol 1e-4 / atol 2e-5."""
    from colearn_federated_learning_tpu_torch.utils import trees

    return all(np.allclose(x, y, rtol=1e-4, atol=2e-5)
               for x, y in zip(trees.leaves(a), trees.leaves(b)))


def async_cli_path(F):
    """14c: ``cli_federation`` with ``coordinate --async-buffer 3`` (K = 3
    = trainers: every aggregation folds one fresh update per trainer, a
    full-participation round up to the fold order): every process exits
    0, ``fold_dense`` launches once per aggregation, each aggregation's
    weight equals the matching 11c round's, and aggregation 0 is 11c's
    round 0 on every run: the same loss, every trainer's update bit for
    bit, the mean and the global params after the server step within f32
    rtol 1e-4 / atol 2e-5.  Both planes fold in an order the processes'
    timing sets (11c: enrollment, 14c: arrival), and the bf16 CNN's next
    round amplifies a last-bit difference of the params (11c against
    itself: 0.116805-0.116936 across runs), so aggregation 1's loss,
    updates, mean and params are held to 11c's round 1 when the two folds
    of round 0 are bitwise equal, and otherwise printed with their
    difference."""
    rec_patch = _Recorder()
    obs = ObservedCoordinator("14c")
    try:
        records, params, launches, took = cli_federation(
            F, cnn_fleet(), coordinate=["--async-buffer", "3", *obs.argv],
            live=obs.live)
    finally:
        rec_patch.close()
    obs.check(records, rec_patch.folders)
    sync, sync_params, sync_folds = RECORDS["11c"]
    log(f"  [14c] the fleet (broker + 3 worker processes, 2 aggregators "
        f"idle) + coordinate --async-buffer 3 ({SOCKET_CLI}, cut: "
        f"num_clients 100 -> 3): fold launches {launches}; path "
        f"{took:.2f} s")
    if not (len(records) == len(sync) == 2
            and len(params) == len(sync_params) == 2
            and len(rec_patch.folders) == len(sync_folds) == 2
            and launches == {"fold_sparse": 0, "fold_dense": 2}):
        raise AssertionError(f"14c: records {records}, launches "
                             f"{launches}")
    comparable = True
    for r, (a, s, pa, ps, fa, fs) in enumerate(zip(
            records, sync, params, sync_params, rec_patch.folders,
            sync_folds)):
        ups_a, ups_s = _by_device(fa), _by_device(fs)
        same_ups = sorted(ups_a) == sorted(ups_s) == ["0", "1", "2"] and all(
            _leaves_equal(ups_a[d], ups_s[d]) for d in ups_s)
        mean_a, mean_s = fa.mean()[0], fs.mean()[0]
        err = _max_abs_diff(mean_a, mean_s)
        perr = _max_abs_diff(pa, ps)
        rel = abs(a["train_loss"] - s["train_loss"]) / abs(s["train_loss"])
        log(f"  [14c] aggregation {r}: train_loss {a['train_loss']!r} "
            f"total_weight {a['total_weight']} fold order {fa.folded_ids} "
            f"agg_time_s {a['agg_time_s']:.3f}; 11c round {r}: train_loss "
            f"{s['train_loss']!r} total_weight {s['total_weight']} fold "
            f"order {fs.folded_ids}; updates bitwise 11c's: {same_ups}; "
            f"mean max abs diff {err:.3e}; params max abs diff {perr:.3e}; "
            f"loss rel diff {rel:.3e}; held to 11c: {comparable}")
        if not (sorted(a["contributors"]) == ["0", "1", "2"]
                and a["staleness_max"] == 0
                and a["total_weight"] == s["total_weight"]):
            raise AssertionError(f"14c: not 11c's full round {r}: {a}")
        if not comparable:
            continue
        if not (same_ups and _close_f32(mean_a, mean_s)
                and _close_f32(pa, ps)
                and math.isclose(a["train_loss"], s["train_loss"],
                                 rel_tol=1e-4, abs_tol=2e-5)):
            raise AssertionError(f"14c: aggregation {r} is not 11c's round "
                                 f"{r} (updates bitwise {same_ups}, mean "
                                 f"diff {err}, params diff {perr}, loss "
                                 f"{a['train_loss']} vs {s['train_loss']})")
        # The next round trains from these params: comparable only if the
        # two folds gave the same bits.
        comparable = _leaves_equal(mean_a, mean_s)
    return launches


def async_phase(A, F, _build):
    """Phase 14: the buffered-asynchronous coordinator on the card."""
    from colearn_federated_learning_tpu_torch.data import registry

    cfg = main_path_config()
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    paths, numbers = {}, {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        t0 = time.perf_counter()
        paths["async_flat"], numbers["14a"] = flat_async_path(
            A, F, dataset, workdir)
        log(f"  14a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["async_tree"], numbers["14b"] = tree_async_path(A, F, dataset)
    log(f"  14b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["async_cli"] = async_cli_path(F)
    log(f"  14c in {time.perf_counter() - t0:.2f} s")
    log("phase 14 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 15
LORA = dict(lora_rank=8, lora_alpha=16.0, lora_merge_every=2)
LORA_ROUNDS = 3            # 15a: round 1 merges, rounds 0 and 2 do not
# 15a-15c run BERT-base at 6 of its 12 blocks (width 768): 37 adapted
# weights at r = 8, 74 factor leaves holding 913,872 float32 entries (the
# JAX package's lora.init_factors at that depth; 146 and 1,577,424 at 12).
LORA_LEAVES, LORA_ENTRIES = 74, 913_872
MERGE_RTOL, MERGE_ATOL = 1e-4, 2e-5


def lora_config(**fed):
    """Config #4 as the socket paths run it at 6 of BERT-base's 12 blocks,
    with rank-8 adapters (α 16, a merge every 2 aggregations)."""
    return socket_config(depth=CUT_DEPTH, **LORA, **fed)


def _cpu_tree(tree):
    """A flax-layout tree of host arrays as CPU tensors."""
    from colearn_federated_learning_tpu_torch.utils import trees

    return trees.map_leaves(
        lambda l: torch.from_numpy(np.array(l, np.float32)), tree)


def _leaf_bytes(tree) -> list:
    from colearn_federated_learning_tpu_torch.utils import trees

    return [np.asarray(l).tobytes() for l in trees.leaves(tree)]


def _check_close(tag, got, want):
    """``got`` (host arrays) within the f32 merge bound of ``want``
    (tensors or arrays), leaf by leaf; returns the max abs difference."""
    from colearn_federated_learning_tpu_torch.utils import trees

    worst = 0.0
    for a, b in zip(trees.leaves(got), trees.leaves(want)):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        if not np.allclose(a, b, rtol=MERGE_RTOL, atol=MERGE_ATOL):
            raise AssertionError(f"{tag}: {np.abs(a - b).max()} off the "
                                 f"host merge (rtol {MERGE_RTOL}, atol "
                                 f"{MERGE_ATOL})")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _factor_shaped(tag, fold_shapes, folders):
    """Every update the folders received is a factor tree (in the wire's
    frame for the codecs): LORA_LEAVES leaves of LORA_ENTRIES entries."""
    from colearn_federated_learning_tpu_torch.utils import trees

    want = [tuple(np.shape(l)) for l in trees.leaves(fold_shapes)]
    n = 0
    for folder in folders:
        for _, delta in folder.received:
            nodes = trees.flatten_up_to(fold_shapes, delta)
            if len(nodes) != LORA_LEAVES:
                raise AssertionError(f"{tag}: an update of {len(nodes)} "
                                     "leaves")
            dense = [np.shape(x) for x in nodes if not isinstance(x, dict)]
            if dense and dense != want:
                raise AssertionError(f"{tag}: an update's shapes differ "
                                     "from the factors'")
            n += 1
    if sum(int(np.prod(s)) for s in want) != LORA_ENTRIES \
            or len(want) != LORA_LEAVES:
        raise AssertionError(f"{tag}: the factor template has {len(want)} "
                             f"leaves of {sum(int(np.prod(s)) for s in want)}"
                             " entries")
    return n


def lora_flat_path(A, F, dataset):
    """15a: a broker, a FederatedCoordinator and 4 DeviceWorkers (3
    trainers and the evaluator) on config #4 (at 6 of BERT-base's 12
    blocks) with rank-8 adapters (α 16, a
    merge every 2), dense factor uplinks and the device fold, 3 rounds and
    an evaluation.  Every update is the factor tree; ``bytes_saved_uplink``
    is the dense frame's length less the factor frame's per update (JAX's
    pricing); each round's ``fold_dense`` is bitwise its host fold; round
    0 leaves the base bit for bit and moves the factors; only round 1
    merges, its base within f32 rtol 1e-4 / atol 2e-5 of the host's merge
    of the base and the factors it merged, B zero and A kept; the
    evaluation scores the temporary merge and leaves the base bit for bit;
    launches exact."""
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.fed import lora
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    cfg = lora_config(fold_device=True)
    fed = cfg.fed
    t0 = time.perf_counter()
    rec_patch = _Recorder()
    broker, workers, coord = _federation(cfg, 4, True, dataset)
    evaluated, merge_s = [], []
    try:
        if len(coord.trainers) != 3 or coord.evaluator is None:
            raise AssertionError("15a: roles not assigned as 3 + 1")
        log(f"  [15a] {cfg.run.name}: bert width {cfg.model.width} "
            f"{cfg.model.dtype}, flash, LoRA r {fed.lora_rank} alpha "
            f"{fed.lora_alpha} merge every {fed.lora_merge_every}, dense "
            f"factor uplinks, fold_device; trainers "
            f"{[d.device_id for d in coord.trainers]}, evaluator "
            f"{coord.evaluator.device_id}; cuts: {SOCKET_CUTS}; depth 12 "
            f"-> {CUT_DEPTH}; up in {time.perf_counter() - t0:.2f} s")
        base0 = host_params(coord.params_tree())
        eval_params, merge = coord._eval_params, coord._merge_lora

        def recorded_eval():
            params = eval_params()
            evaluated.append(host_params(params))
            return params

        def timed_merge():
            torch.cuda.synchronize()
            t = time.perf_counter()
            merge()
            torch.cuda.synchronize()
            merge_s.append(time.perf_counter() - t)

        coord._eval_params, coord._merge_lora = recorded_eval, timed_merge
        A.reset_launches()
        F.reset_launches()
        records, snaps = [], []
        for _ in range(LORA_ROUNDS):
            records.append(coord.run_round())
            snaps.append((host_params(coord.params_tree()),
                          host_params(coord._factors)))
        t1 = time.perf_counter()
        ev = coord.evaluate()
        eval_s = time.perf_counter() - t1
        launches = {**A.launches, **F.launches}
        after_eval = host_params(coord.params_tree())
        local_s = [sp.duration_s for sp in coord.tracer.snapshot()
                   if sp.name == "local_train"]
        shapes, fold_shapes = coord._shapes_np, coord._fold_shapes
    finally:
        rec_patch.close()
        _stop(broker, workers, coord)
    for r in records:
        log(f"  [15a] round {r['round']}: {r['round_time_s']:.3f} s, "
            f"train_loss {r['train_loss']:.6f}, completed {r['completed']}, "
            f"lora_merged {r['lora_merged']}, phase_broadcast_collect_s "
            f"{r['phase_broadcast_collect_s']:.3f}, phase_aggregate_s "
            f"{r['phase_aggregate_s']:.3f}, bytes_saved_uplink "
            f"{r['bytes_saved_uplink']}")
        if not (r["completed"] == 3 and not r["dropped"]
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"15a: bad round record {r}")
    if [r["lora_merged"] for r in records] != [False, True, False]:
        raise AssertionError(f"15a: lora_merged "
                             f"{[r['lora_merged'] for r in records]}")
    # JAX's pricing: the dense frame less the factor frame, per update.
    meta = {"round": 0, "op": "train", "compress": "none"}
    saved = (wire_frame_length(shapes, meta)
             - wire_frame_length(fold_shapes, meta))
    if [r["bytes_saved_uplink"] for r in records] != [3 * saved] * 3:
        raise AssertionError(f"15a: bytes_saved_uplink "
                             f"{[r['bytes_saved_uplink'] for r in records]}"
                             f", expected {3 * saved} per round")
    updates = _factor_shaped("15a", fold_shapes, rec_patch.folders)
    for r, folder in enumerate(rec_patch.folders):
        if not _same_fold(folder, _host_fold(fold_shapes, folder.folded_ids,
                                             folder.received)):
            raise AssertionError(f"15a: round {r}'s device fold differs "
                                 "from its host fold")
    (b0, f0), (b1, f1), (b2, f2) = snaps
    if _leaf_bytes(b0) != _leaf_bytes(base0):
        raise AssertionError("15a: round 0 moved the base")
    if not any(np.any(b != 0) for _, b in lora.factor_index(f0).values()):
        raise AssertionError("15a: round 0 left B at zero")
    # Round 1: the factors it merged are round 0's plus the mean delta.
    mean1, _, _ = rec_patch.folders[1].mean()
    merged_f = trees.map_leaves(
        lambda f, d: f + np.float32(fed.server_lr) * d, f0, mean1)
    err1 = _check_close("15a round 1", b1, lora.merge_adapters(
        _cpu_tree(b0), _cpu_tree(merged_f), fed.lora_alpha, fed.lora_rank))
    for path, (a, b) in lora.factor_index(f1).items():
        if np.any(b != 0) or not np.array_equal(
                a, lora.factor_index(merged_f)[path][0]):
            raise AssertionError(f"15a: after the merge {path}'s B is not "
                                 "zero or its A changed")
    if _leaf_bytes(b2) != _leaf_bytes(b1):
        raise AssertionError("15a: round 2 moved the base")
    err_eval = _check_close("15a evaluation", evaluated[0], lora.merge_adapters(
        _cpu_tree(b2), _cpu_tree(f2), fed.lora_alpha, fed.lora_rank))
    if _leaf_bytes(after_eval) != _leaf_bytes(b2) \
            or not math.isfinite(ev["eval_loss"]):
        raise AssertionError(f"15a: the evaluation moved the base or gave "
                             f"{ev}")
    depth, steps = cfg.model.depth, fed.local_steps
    trained = LORA_ROUNDS * 3 * steps
    eval_batches = math.ceil(len(dataset.x_test)
                             / max(fed.batch_size, 64))
    want = {"flash_forward": depth * (trained + eval_batches),
            "flash_backward_dq": depth * trained,
            "flash_backward_dkv": depth * trained,
            "fold_sparse": 0, "fold_dense": LORA_ROUNDS}
    # The merge reads and writes every adapted weight once (the factors
    # are 1.5 % of it).
    adapted = sum(int(np.prod(s)) for s in lora.target_paths(
        shapes, model_name=cfg.model.name).values())
    merge_bound_ms = 1e3 * (8 * adapted + 4 * LORA_ENTRIES) / HBM_BYTES_PER_S
    per_step = sum(local_s) / len(local_s) / steps
    log(f"  [15a] {updates} updates, each {LORA_LEAVES} factor leaves of "
        f"{LORA_ENTRIES} f32 ({4 * LORA_ENTRIES / 1e6:.2f} MB); "
        f"bytes_saved_uplink {saved} per update (dense frame less factor "
        f"frame); every round's device fold == its host fold (bitwise); "
        f"round 0 kept the base bit for bit; round 1's merge within "
        f"{err1:.3e} of the host merge, B zero, A kept; the evaluation "
        f"scored the temporary merge ({err_eval:.3e} off the host merge) "
        f"and left the base bit for bit: loss {ev['eval_loss']:.6f} acc "
        f"{ev['eval_acc']:.4f} in {eval_s:.3f} s; merge "
        f"{[round(t * 1e3, 3) for t in merge_s]} ms (bound "
        f"{merge_bound_ms:.3f} ms, {8 * adapted / 1e6:.1f} MB of adapted "
        f"base read and written); local_train {per_step * 1e3:.2f} ms per "
        f"step; launches {launches}; path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    if launches != want:
        raise AssertionError(f"15a: launches {launches}, expected {want}")
    return launches, {"round_s": [r["round_time_s"] for r in records],
                      "collect_s": [r["phase_broadcast_collect_s"]
                                    for r in records],
                      "merge_ms": [t * 1e3 for t in merge_s],
                      "merge_bound_ms": merge_bound_ms,
                      "local_train_s_per_step": per_step}


def lora_tree_path(A, F, dataset):
    """15b: 12a's tree (4 trainer threads, 2 AggregatorServers with the
    device fold, heartbeat timeout 2 s, no evaluator) with rank-8 adapters
    and topk8 factor uplinks with error feedback, 2 rounds and no
    failover: each slice's ``fold_sparse`` of factor updates is bitwise its
    host fold, the root's ``fold_dense`` of the 2 factor partials bitwise
    the slice-blocked host fold, every trainer's frame carried the
    ``lora`` marker through the tier, round 1 merges; launches exact."""
    from colearn_federated_learning_tpu_torch.comm import worker as worker_lib
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.comm.aggregator import (
        slice_cohort)

    cfg = lora_config(compress="topk8", compress_feedback=True,
                      fold_device=True, num_aggregators=2,
                      agg_heartbeat_timeout=2.0)
    t0 = time.perf_counter()
    seen = []
    train = worker_lib.DeviceWorker._train

    def recorded_train(w, round_idx, global_params, cohort=None, meta=None,
                       shares_in=None):
        seen.append((w.client_id, round_idx, dict(meta or {})))
        return train(w, round_idx, global_params, cohort=cohort, meta=meta,
                     shares_in=shares_in)

    worker_lib.DeviceWorker._train = recorded_train
    rec_patch, timer, aggs = _Recorder(), None, []
    try:
        broker, workers, coord = _federation(cfg, 4, False, dataset)
        try:
            aggs = _tree(cfg, broker, 2)
            coord.enroll_aggregators(timeout=120.0)
            order = [d.device_id for d in coord.trainers]
            A.reset_launches()
            F.reset_launches()
            timer = _FoldTimer(F)
            records = [coord.run_round() for _ in range(2)]
            launches = {**A.launches, **F.launches}
            dense_us = timer.per_launch_us("dense")
            fold_shapes = coord._fold_shapes
        finally:
            if timer is not None:
                timer.close()
            for agg in aggs:
                agg.stop()
            _stop(broker, workers, coord)
    finally:
        rec_patch.close()
        worker_lib.DeviceWorker._train = train
    for r in records:
        log(f"  [15b] round {r['round']}: {r['round_time_s']:.3f} s, "
            f"train_loss {r['train_loss']:.6f}, completed {r['completed']}, "
            f"aggregators {r['aggregators']}, lora_merged {r['lora_merged']}"
            f", phase_broadcast_collect_s "
            f"{r['phase_broadcast_collect_s']:.3f}, phase_agg_fold_s "
            f"{r['phase_agg_fold_s']:.3f}")
        if not (r["aggregators"] == 2 and r["completed"] == 4
                and not r["dropped"] and "agg_failovers" not in r
                and math.isfinite(r["train_loss"])):
            raise AssertionError(f"15b: bad round record {r}")
    if [r["lora_merged"] for r in records] != [False, True]:
        raise AssertionError("15b: lora_merged "
                             f"{[r['lora_merged'] for r in records]}")
    markers = sorted((c, r, m.get("lora")) for c, r, m in seen)
    if markers != sorted((int(c), r, LORA["lora_rank"]) for c in order
                         for r in range(2)):
        raise AssertionError(f"15b: the trainers' frames carried {markers}")
    if len(rec_patch.agg_folders) != 4 or len(rec_patch.folders) != 2:
        raise AssertionError(f"15b: {len(rec_patch.agg_folders)} slice "
                             f"folds, {len(rec_patch.folders)} root folds")
    updates = _factor_shaped("15b", fold_shapes, rec_patch.agg_folders)
    by_round = {}
    for f in rec_patch.agg_folders:
        if not _same_fold(f, _host_fold(fold_shapes, f.folded_ids,
                                        f.received)):
            raise AssertionError("15b: a slice's fold_sparse differs from "
                                 "its host fold")
        by_round.setdefault(int(f.received[0][0]["round"]), []).extend(
            f.received)
    for r, root in enumerate(rec_patch.folders):
        host = _host_fold(fold_shapes, order, by_round[r],
                          slice_cohort(order, 2))
        if len(by_round[r]) != 4 or not _same_fold(root, host):
            raise AssertionError(f"15b: round {r}'s root fold_dense differs "
                                 "from the slice-blocked host fold")
    # The slice folds replayed alone on the card, as 12a's.
    timer = _FoldTimer(F)
    try:
        for f in rec_patch.agg_folders:
            again = StreamingFolder(fold_shapes, order=f.folded_ids,
                                    device_fold=True)
            for meta, delta in f.received:
                again.add(meta, delta)
            again.finalize()
            if not _same_fold(again, f):
                raise AssertionError("15b: a replayed slice fold differs")
        sparse_us = timer.per_contribution_us("sparse")
        stage_us = timer.per_contribution_us("stage")
    finally:
        timer.close()
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    trained = 2 * 4 * steps
    want = {"flash_forward": depth * trained,
            "flash_backward_dq": depth * trained,
            "flash_backward_dkv": depth * trained,
            "fold_sparse": 2 * 4, "fold_dense": 2}
    log(f"  [15b] {updates} topk8 factor updates; every slice fold == its "
        f"host fold and every root sum == the slice-blocked host fold "
        f"(bitwise); the lora marker reached all {len(seen)} train "
        f"requests through the tier; replayed alone: fold_sparse "
        f"{sparse_us:.2f} us device, staging copy {stage_us:.2f} us per "
        f"factor contribution; root fold_dense {dense_us:.2f} us per "
        f"launch of 2 factor partials; launches {launches}; path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    if launches != want:
        raise AssertionError(f"15b: launches {launches}, expected {want}")
    return launches, {"round_s": [r["round_time_s"] for r in records],
                      "fold_sparse_us": sparse_us, "stage_us": stage_us,
                      "root_fold_dense_us": dense_us}


def lora_secure_path(A, F, dataset):
    """15c: 11b's DH secure aggregation with rank-8 adapters: 4 trainers, 1
    round, trainer 2's train reply lost after the share phase; the masks
    and their recovery run on the factor tree, and the recovered aggregate
    is the survivors' unmasked factor sum within 1e-5 (11b's
    ``check_recovery``)."""
    from colearn_federated_learning_tpu_torch import faults
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg = lora_config(secure_agg=True, comm_retries=0)
    t0 = time.perf_counter()
    rec_patch = _Recorder(masks=True)
    broker, workers, coord = _federation(cfg, 4, False, dataset)
    try:
        A.reset_launches()
        F.reset_launches()
        faults.install(faults.FaultPlan.from_json(json.dumps(DROP_REPLY_2)))
        try:
            rec = coord.run_round()
        finally:
            faults.uninstall()
        launches = {**A.launches, **F.launches}
        fold_shapes = coord._fold_shapes
    finally:
        rec_patch.close()
        _stop(broker, workers, coord)
    if not (rec["completed"] == 3 and rec["dropped"] == ["2"]
            and rec["unmask_failed"] is False):
        raise AssertionError(f"15c: bad round record {rec}")
    folder = rec_patch.folders[0]
    survivors = [int(c) for c in folder.folded_ids]
    _factor_shaped("15c", fold_shapes, [folder])
    depth, steps = cfg.model.depth, cfg.fed.local_steps
    want = {"flash_forward": depth * 4 * steps,
            "flash_backward_dq": depth * 4 * steps,
            "flash_backward_dkv": depth * 4 * steps,
            "fold_sparse": 0, "fold_dense": 0}
    log(f"  [15c] secure DH round over the factors, 4 trainers, trainer 2's "
        f"reply lost: survivors {survivors}, dropped {rec['dropped']}, "
        f"unmask_failed {rec['unmask_failed']}; round "
        f"{rec['round_time_s']:.3f} s; launches {launches}; path "
        f"{time.perf_counter() - t0:.2f} s")
    if survivors != [0, 1, 3]:
        raise AssertionError(f"15c: survivors {survivors}")
    check_recovery("15c", trees.leaves(folder.wsum), rec_patch.unmasked,
                   survivors, [delta for _, delta in folder.received])
    if launches != want:
        raise AssertionError(f"15c: launches {launches}, expected {want}")
    return launches


LORA_CLI = ["--lora-rank", "4"]


def lora_cli_path(F):
    """15d: ``cli coordinate --lora-rank 4 --lora-merge-every 2
    --fold-device --no-evaluator`` on config #2's CNN against a fleet of
    its own (``cli broker`` and 3 x ``cli worker --lora-rank 4``, started
    with phase 15; ``cli_federation``), 2 rounds, then the fleet stopped
    with SIGTERM: every process exits 0, every round is complete, the
    updates adapt
    exactly the CNN's Conv (HWIO) and Dense kernels, round 1 merges,
    ``fold_dense`` launches once per round.  The loss is printed, not
    held: config #2's SGD (lr 0.05, momentum 0.9) diverges under the
    adapters' α/r = 4 over its 34 local steps, the JAX package's trainer
    as the port's (ROADMAP Queue C)."""
    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.fed import lora, setup

    coordinate = [*LORA_CLI, "--lora-merge-every", "2"]
    t0 = time.perf_counter()
    rec_patch = _Recorder()
    fleet = FLEETS["lora"]          # started with phase 15
    try:
        records, _, launches, _ = cli_federation(F, fleet,
                                                 coordinate=coordinate)
    finally:
        rec_patch.close()
        codes = FLEETS.pop("lora").close()
    took = time.perf_counter() - t0
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["coordinate", *SOCKET_CLI, *coordinate, "--broker-port", "0"]))
    shapes = setup.init_global_params(cfg, "cpu")
    kernels = sorted(
        "/".join(path) for path, _ in lora._leaves_with_path(shapes)
        if path[-1] == "kernel" and path[-2].startswith(("Conv", "Dense")))
    targets = sorted(lora.target_paths(shapes, model_name=cfg.model.name))
    got = sorted(lora.factor_index(rec_patch.folders[0].received[0][1]))
    merged = [r.get("lora_merged") for r in records]
    log(f"  [15d] broker + 3 worker processes ({LORA_CLI}) + coordinate "
        f"({SOCKET_CLI}, cut: num_clients 100 -> 3): lora_merged {merged}; "
        f"adapted {got}; train_loss {[r['train_loss'] for r in records]} "
        f"(config #2's SGD diverges under alpha/r = 4, JAX's too); exit "
        f"codes {codes}; fold "
        f"launches {launches}; path {took:.2f} s")
    if not (codes == [0, 0, 0, 0] and merged == [False, True]
            and all(r["completed"] == 3 and not r["dropped"]
                    for r in records)
            and launches["fold_dense"] == 2 and launches["fold_sparse"] == 0):
        raise AssertionError(f"15d: codes {codes}, records {records}, "
                             f"launches {launches}")
    if not (kernels and got == targets == kernels):
        raise AssertionError(f"15d: adapted {got}, the rules target "
                             f"{targets}, the Conv/Dense kernels {kernels}")
    return launches


def factor_fold_rows(F, fold_shapes):
    """The fold kernel at BERT-base's factor layout (146 slots, r = 8):
    ``fold_dense`` of 3 contributions (15a's batch) and of 2 partials (15b's
    root) and ``fold_sparse`` of topk8 contributions at 5 % density (15b's
    slices), each bitwise its plain version, then timed as 9a times them
    (device time by CUDA-graph replay over input sets of more than twice
    the L2, the staging copy, the plain version, ``torch.sum`` or
    ``index_add_``, and the bound)."""
    from colearn_federated_learning_tpu_torch.utils import trees

    sizes = [int(np.prod(np.shape(l))) for l in trees.leaves(fold_shapes)]
    kernel = F.get_kernel(sizes)
    g = torch.Generator(device="cuda").manual_seed(151)
    offs = kernel.offsets
    rows = {}
    for label, n in (("fold_dense x3", 3), ("fold_dense x2", 2)):
        nsets = max(4, math.ceil(2 * L2_BYTES / (4 * n * kernel.total)))
        sets = []
        for _ in range(nsets):
            flat = torch.randn(n, kernel.total, generator=g,
                               device="cuda").cpu().numpy()
            sets.append(kernel.stage_dense([
                [row[a:b] for a, b in zip(offs[:-1], offs[1:])]
                for row in flat]))
        x = sets[0]
        got = kernel.fold_dense_staged(None, x)
        bits_equal(f"15 {label}", got, F.fold_dense_reference(
            torch.empty_like(got), x, True))
        ms = device_ms(lambda s: kernel.fold_dense_staged(None, s), sets)
        out = torch.empty(kernel.total, dtype=torch.float32, device="cuda")
        plain = time_ms(lambda: F.fold_dense_reference(out, x, True),
                        iters=10)
        library = device_ms(lambda s: torch.sum(s, dim=0), sets)
        h2d = time_ms(lambda: kernel._pinned[:x.numel() * 4].to(
            "cuda", non_blocking=True), iters=10)
        t_bytes = (x.numel() + kernel.total) * 4 / HBM_BYTES_PER_S
        t_ops = x.numel() / F32_FLOP_PER_S
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                       "h2d_ms": h2d, "bound_ms": 1e3 * max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
    batch = sparse_batch(sizes, FOLD_ROWS, True, 152)
    st = kernel.stage_sparse(batch)
    bits_equal("15 fold_sparse topk8", kernel.fold_sparse_staged(None, st),
               plain_sparse(F, kernel, st, None))
    naccs = max(4, math.ceil(2 * L2_BYTES / (4 * kernel.total)))
    accs = [torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
            for _ in range(naccs)]
    ms = device_ms(lambda acc: kernel.fold_sparse_staged(acc, st),
                   accs) / FOLD_ROWS
    plain = time_ms(lambda: plain_sparse(F, kernel, st, accs[0]),
                    iters=3) / FOLD_ROWS
    entries = [global_entries(kernel, p) for p in st.parts]

    def yardstick():
        for (gi, sc), p in zip(entries, st.parts):
            accs[0].index_add_(0, gi, (p.vals.float() * sc) * float(p.weight))

    library = time_ms(yardstick, iters=3) / FOLD_ROWS
    in_bytes = sum(staged_bytes(p) for p in st.parts)
    nbytes = (in_bytes + sum(SECTOR * 2 * int(torch.unique_consecutive(
        gi // (SECTOR // 4)).numel()) for gi, _ in entries)) / FOLD_ROWS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * st.entries / FOLD_ROWS / F32_FLOP_PER_S
    h2d_bytes = max(staged_bytes(p) for p in st.parts)
    dst = torch.empty(h2d_bytes, dtype=torch.uint8, device="cuda")
    h2d = time_ms(lambda: dst.copy_(kernel._pinned[:h2d_bytes],
                                    non_blocking=True), iters=10)
    rows["fold_sparse topk8"] = {
        "ms": ms, "plain_ms": plain, "library_ms": library, "h2d_ms": h2d,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    for label, r in rows.items():
        log(f"  [15] {label} at the factor layout ({len(sizes)} slots, "
            f"{kernel.total} entries): {r['ms'] * 1e3:.2f} us device "
            f"({r['bound_ms'] / r['ms']:.1%} of bound "
            f"{r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}); staging copy "
            f"{r['h2d_ms'] * 1e3:.2f} us; plain {r['plain_ms'] * 1e3:.2f} "
            f"us; {'index_add_' if 'sparse' in label else 'torch.sum'} "
            f"{r['library_ms'] * 1e3:.2f} us; {card()}")
    return rows


def lora_phase(A, F):
    """Phase 15: LoRA adapter federation on the card, on config #4 (and
    config #2 through the processes)."""
    from colearn_federated_learning_tpu_torch.data import registry
    from colearn_federated_learning_tpu_torch.fed import lora

    cfg = main_path_config()
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    paths, numbers = {}, {}
    # 15d's fleet starts first: its processes make their CUDA contexts and
    # draw CIFAR-10 while 15a-15c run.
    FLEETS["lora"] = CliFleet(worker=LORA_CLI)
    t0 = time.perf_counter()
    paths["lora_flat"], numbers["15a"] = lora_flat_path(
        A, F, dataset)
    log(f"  15a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["lora_tree"], numbers["15b"] = lora_tree_path(A, F, dataset)
    log(f"  15b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["lora_secure"] = lora_secure_path(A, F, dataset)
    log(f"  15c in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["lora_cli"] = lora_cli_path(F)
    log(f"  15d in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    # The factor layout at BERT-base's full depth (146 slots), whatever
    # depth 15a-15c run at.
    numbers["factor_folds"] = factor_fold_rows(F, lora.init_factors(
        bert_params(), LORA["lora_rank"], model_name="bert", device="cpu"))
    log(f"  factor-layout folds in {time.perf_counter() - t0:.2f} s")
    log("phase 15 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 16
# Phase 16's checkpoints live under one temporary directory inside the
# gitignored build directory (main() makes it and removes it): 13a's
# untraced run, 11a's and 14a's federations save into it, and phase 16
# checks what they saved.  ``CKPT[name]`` keeps what a save left to check.
CKPT: dict = {"root": None}


def ckpt_dir(name: str) -> str:
    return os.path.join(CKPT["root"], name)


def save_checkpoint_of(coord, name: str, params) -> None:
    """Save a coordinator's live state through its checkpointer (streaming
    with ``ckpt_stream``), as ``fit``'s last round would, and keep the
    config, the host params at the save and the save's numbers for 16c."""
    t0 = time.perf_counter()
    coord.save_checkpoint()
    CKPT[name] = {"cfg": coord.config, "params": params,
                  "round_idx": coord.server_state.round_idx,
                  "step": len(coord.history),
                  "stats": dict(coord._ckpt.last_save_stats),
                  "wall_s": time.perf_counter() - t0}


def _stderr_of(fn):
    """Run ``fn()`` with this process's stderr captured; the text is
    written to the real stderr afterwards and returned beside the
    result."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            out = fn()
    finally:
        sys.stderr.write(err.getvalue())
        sys.stderr.flush()
    return out, err.getvalue()


def _events(text: str) -> dict:
    return {e["event"]: e for e in (json.loads(line) for line in
                                    text.splitlines()
                                    if line.startswith('{"event"'))}


def resume_engine_path(A):
    """16a: ``train`` through ``cli.main`` on config #4 (BERT-base, flash,
    4 local steps) for 1 round with ``--checkpoint-dir D``, then ``train
    --rounds 2 --checkpoint-dir D --resume``: stderr says ``resumed at
    round 1``, the second run trains round 1 alone with exact K1-K3
    launches, and its step-2 checkpoint, read leaf by leaf, equals 13a's
    uninterrupted run's step-2 checkpoint bit for bit."""
    from colearn_federated_learning_tpu_torch.ckpt import RoundCheckpointer

    d = ckpt_dir("16a_resumed")
    first = list(BERT_TRACE)
    first[first.index("--rounds") + 1] = "1"
    _, l1, learner = cli_path(A, "16a first", [*first, "--checkpoint-dir", d])
    del learner
    (recs, l2, learner), err = _stderr_of(lambda: cli_path(
        A, "16a resumed", [*BERT_TRACE, "--checkpoint-dir", d, "--resume"]))
    del learner
    if "resumed at round 1" not in err.splitlines():
        raise AssertionError("16a: no 'resumed at round 1' on stderr")
    if [r["round"] for r in recs] != [1]:
        raise AssertionError(f"16a: resumed rounds "
                             f"{[r['round'] for r in recs]}")
    straight = RoundCheckpointer(ckpt_dir("16a_straight"))
    resumed = RoundCheckpointer(d)
    if not straight.latest_step() == resumed.latest_step() == 2:
        raise AssertionError(f"16a: steps {straight.latest_step()}, "
                             f"{resumed.latest_step()}")
    n, nbytes, differ = 0, 0, []
    for (pa, a), (pb, b) in zip(straight.load_leaves(2),
                                resumed.load_leaves(2)):
        n += 1
        nbytes += a.numel() * a.element_size()
        if pa != pb or a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"16a: leaf {pa} against {pb}")
        if not torch.equal(a, b):
            differ.append((pa, float((a.double() - b.double()).abs().max())))
    log(f"  [16a] train --rounds 1, then --rounds 2 --resume (cut as 13a: "
        f"local_steps 150 -> 4): 'resumed at round 1'; step 2 against 13a's "
        f"uninterrupted step 2: {n} leaves, {nbytes / 1e6:.1f} MB, "
        f"{len(differ)} differ {differ[:3]}; {card()}")
    if differ or n == 0:
        raise AssertionError(f"16a: the resumed checkpoint differs from the "
                             f"uninterrupted one in {differ}")
    return {"resume_engine_first": l1, "resume_engine": l2}


def _line_queue(stream):
    """A queue of ``stream``'s lines read on a thread (``None`` at EOF)."""
    import queue

    q = queue.Queue()

    def pump():
        for line in stream:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return q


def resume_cli_path(F):
    """16b: a ``cli coordinate --fold-device --no-evaluator
    --checkpoint-dir D --checkpoint-every 1 --ckpt-stream`` process
    against the CNN fleet of 11c (its broker and 3 worker processes; 12c's
    aggregators idle), the coordinator SIGKILLed as soon as round 0's
    record line is out (its checkpoint is committed before the line),
    then ``coordinate ...
    --resume`` through ``cli.main`` in this process against the live
    broker and workers: the ``resumed`` event says round 1, no generation
    discarded, and the digest of ``load_generation_host(D)`` at
    generation 1; ``challenge_verified`` lists the 3 workers and no
    rejection; the WAL holds 2 entries; round 1 runs through
    ``fold_dense`` once.  Then the fleet is stopped with SIGTERM and every
    process of it exits 0.  Its params are held to 11c's round 1 bit for
    bit when the killed run's round-0 state is 11c's bit for bit and the
    two round-1 folds' orders agree; otherwise the difference is
    printed."""
    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.ckpt import (
        RoundWal, load_generation_host)
    from colearn_federated_learning_tpu_torch.comm import coordinator
    from colearn_federated_learning_tpu_torch.comm.downlink import (
        host_params)
    from colearn_federated_learning_tpu_torch.utils import trees

    d = ckpt_dir("16b")
    fleet = cnn_fleet()
    t0 = time.perf_counter()
    records, params = [], []
    victim = None
    rec_patch = _Recorder()
    try:
        argv = ["coordinate", *SOCKET_CLI, "--broker-port", fleet.port,
                "--min-devices", "3", "--no-evaluator", "--fold-device",
                "--checkpoint-dir", d, "--checkpoint-every", "1",
                "--ckpt-stream", "--enroll-timeout", "300",
                "--round-timeout", str(SOCKET_TIMEOUT)]
        victim = subprocess.Popen([*CLI_MOD, *argv], env=fleet.env,
                                  cwd=fleet.root, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
        lines = _line_queue(victim.stderr)
        deadline = time.monotonic() + 600.0
        while True:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            if line is None:
                raise AssertionError("16b: the coordinator exited before "
                                     "round 0's record")
            sys.stderr.write(line)
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if (isinstance(rec, dict) and rec.get("round") == 0
                    and "event" not in rec):
                victim.send_signal(signal.SIGKILL)
                break
        victim_code = victim.wait(60)
        killed_s = time.perf_counter() - t0
        F.reset_launches()
        orig = coordinator.FederatedCoordinator.run_round

        def kept(self):
            rec = orig(self)
            records.append(rec)
            params.append(host_params(self.params_tree()))
            return rec

        coordinator.FederatedCoordinator.run_round = kept
        try:
            last, err = _stderr_of(lambda: cli.main([*argv, "--resume"]))
        finally:
            coordinator.FederatedCoordinator.run_round = orig
        launches = dict(F.launches)
        fleet.check_alive("16b")
        codes = FLEETS.pop("cnn").close()
    finally:
        rec_patch.close()
        if victim is not None and victim.poll() is None:
            victim.kill()
            victim.wait(10)
    events = _events(err)
    gen, gstep, digest = load_generation_host(d, step=1)
    wal = RoundWal(d).load()
    resumed, verdict = events.get("resumed", {}), events.get(
        "challenge_verified", {})
    log(f"  [16b] the fleet (broker + 3 worker processes, 2 aggregators "
        f"idle) + coordinate ({SOCKET_CLI}, cut: num_clients 100 -> 3) "
        f"SIGKILLed after round 0's record (exit {victim_code}, "
        f"{killed_s:.2f} s), then coordinate --resume in this process: "
        f"{json.dumps(resumed)}; {json.dumps(verdict)}; WAL rounds "
        f"{[e['round'] for e in wal]}; the fleet's exit codes {codes} "
        f"(11c-16b); fold launches {launches}; path "
        f"{time.perf_counter() - t0:.2f} s")
    if not (victim_code == -signal.SIGKILL and codes == [0] * 6
            and resumed.get("round") == 1
            and resumed.get("ckpt_discarded") == 0
            and resumed.get("ckpt_digest") == digest and gstep == 1
            and sorted(verdict.get("verified", [])) == ["0", "1", "2"]
            and verdict.get("rejected") == []
            and [e["round"] for e in wal] == [0, 1]
            and [r["round"] for r in records] == [1] and last is records[-1]
            and last["completed"] == 3 and math.isfinite(last["train_loss"])
            and launches == {"fold_sparse": 0, "fold_dense": 1}):
        raise AssertionError(f"16b: victim {victim_code}, codes {codes}, "
                             f"events {events}, WAL {wal}, records "
                             f"{records}, launches {launches}")
    sync, sync_params, sync_folds = RECORDS["11c"]
    state0 = [v for k, v in gen.items() if k.startswith("0/params/")]
    same0 = all(a.numpy().tobytes() == np.asarray(b).tobytes()
                for a, b in zip(state0, trees.leaves(sync_params[0])))
    order, order_11c = (rec_patch.folders[0].folded_ids,
                        sync_folds[1].folded_ids)
    comparable = same0 and list(order) == list(order_11c)
    diff = _max_abs_diff(params[0], sync_params[1])
    log(f"  [16b] round 1 train_loss {last['train_loss']!r} (11c's "
        f"{sync[1]['train_loss']!r}); round-0 state bitwise 11c's: {same0};"
        f" round-1 fold order {list(order)} (11c's {list(order_11c)}); "
        f"params after round 1 max abs diff from 11c's {diff:.3e}; held "
        f"bitwise: {comparable}; {card()}")
    if comparable and not _leaves_equal(params[0], sync_params[1]):
        raise AssertionError(f"16b: round 1 after the resume differs from "
                             f"11c's round 1 by {diff}")
    return launches


def restore_check(name: str) -> dict:
    """16c: a fresh coordinator of the saved one's kind and config
    restores the streaming checkpoint that ``save_checkpoint_of`` made:
    the restored params equal the live ones bit for bit (the version and
    ``round_idx`` too), and ``last_restore_digest`` equals
    ``load_generation_host``'s.  Returns the save's and the restore's
    numbers."""
    from colearn_federated_learning_tpu_torch.ckpt import (
        load_generation_host)
    from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
        AsyncFederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params

    saved = CKPT[name]
    cfg = saved["cfg"]
    # No trace or ledger for the fresh coordinator: their directories are
    # gone with their phase.
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, trace_dir=None,
                                              health_dir=None))
    t0 = time.perf_counter()
    broker = MessageBroker().start()
    try:
        if "version" in saved:
            coord = AsyncFederatedCoordinator(cfg, broker.host, broker.port,
                                              buffer_size=ASYNC_K)
        else:
            coord = FederatedCoordinator(cfg, broker.host, broker.port)
        try:
            step = coord.restore_checkpoint()
            restored = host_params(coord.params_tree())
            ckpt = coord._ckpt
            digest, stats = ckpt.last_restore_digest, ckpt.last_restore_stats
            version = getattr(coord, "version", None)
            round_idx = coord.server_state.round_idx
        finally:
            coord.close()
    finally:
        broker.stop()
    _, gstep, host_digest = load_generation_host(ckpt_dir(name))
    save = saved["stats"]
    mb = save["bytes"] / 1e6
    out = {"save_s": save["save_s"], "save_MB": mb,
           "save_MB_per_s": mb / save["save_s"], "shards": save["shards"],
           "crc_share": save["crc_s"] / save["save_s"],
           "restore_s": stats["restore_s"],
           "restore_MB_per_s": stats["bytes"] / 1e6 / stats["restore_s"],
           "path_s": time.perf_counter() - t0}
    equal = _leaves_equal(restored, saved["params"])
    log(f"  [16c {name}] step {step} (generation {gstep}), version "
        f"{version}, round_idx {round_idx}: params bitwise the live ones: "
        f"{equal}; digest {digest[:16]}... == load_generation_host's: "
        f"{digest == host_digest}; ckpt.save_s {save['save_s']:.3f} s for "
        f"{mb:.1f} MB ({out['save_MB_per_s']:.1f} MB/s), {save['shards']} "
        f"shard file(s), the CRC pass {100 * out['crc_share']:.1f} % of the "
        f"save; ckpt.restore_s {stats['restore_s']:.3f} s "
        f"({out['restore_MB_per_s']:.1f} MB/s); path "
        f"{out['path_s']:.2f} s; {card()}")
    if not (equal and digest == host_digest and step == gstep
            == saved["step"] and round_idx == saved["round_idx"]
            and version == saved.get("version")):
        raise AssertionError(f"16c {name}: restored step {step}, version "
                             f"{version}, round_idx {round_idx}, params "
                             f"equal {equal}, digests {digest} "
                             f"{host_digest}")
    return out


def resume_phase(A, F):
    """Phase 16: checkpoints and resume on the card (16a the engine, 16b
    the processes with a SIGKILL, 16c the streaming restores of 11a's and
    14a's federations)."""
    paths, numbers = {}, {}
    t0 = time.perf_counter()
    paths.update(resume_engine_path(A))
    log(f"  16a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["resume_cli"] = resume_cli_path(F)
    log(f"  16b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    numbers["16c_sync"] = restore_check("16c_sync")
    numbers["16c_async"] = restore_check("16c_async")
    numbers["16c_async"]["save_path_s"] = CKPT["16c_async"]["path_s"]
    log(f"  16c in {time.perf_counter() - t0:.2f} s")
    log("phase 16 numbers " + json.dumps(numbers))
    return paths


# ------------------------------------------------------------ phase 17
CHAOS_ROUNDS = 6           # the canned schedule's three kills need 6


def chaos_mp_path() -> dict:
    """17a: ``chaos --mp --rounds 6 --num-workers 3`` through ``cli.main``
    on the card: the broker, 3 workers and the coordinator as processes
    of the port's command line (config #1's MLP, 784-200-200-10 in f32,
    on ``mnist_tiny``), worker 1 SIGKILLed after round 1 and respawned,
    the coordinator after round 2 and resumed with ``--resume``, the
    broker after round 3 and respawned on its port.  The command's own
    gate passes (it exits 1 otherwise): every round recorded, a final
    score, a resume, a parseable flight dump of every killed pid.  Then:
    the three kills with their pids, two coordinator incarnations, one
    dump per process started (8), and every child but the broker (which
    holds no tensor) ran on the card: ``--backend gpu`` in its argv and
    a ``device`` event naming ``cuda`` in its dump."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    d = CKPT["chaos"]
    arrivals = []                  # (host seconds, round) per record line
    log_rec = cli._chaos_log

    def timed(rec):
        arrivals.append((time.perf_counter(), rec["round"]))
        log_rec(rec)

    t0 = time.perf_counter()
    cli._chaos_log = timed
    try:
        summary = cli.main(["chaos", "--mp", "--rounds", str(CHAOS_ROUNDS),
                            "--num-workers", "3", "--workdir", d])
    finally:
        cli._chaos_log = log_rec
    took = time.perf_counter() - t0
    kills = [(k["target"], k["fired_after_round"], k.get("pid"))
             for k in summary["kills"]]
    # Time to recover: the harness kills as it reads the record of the
    # kill's round, so it runs from that record to the next round's.
    recover = {}
    for target, after, _ in kills:
        t_kill = next(t for t, r in arrivals if r == after)
        recover[target] = round(next(t for t, r in arrivals
                                     if t > t_kill and r > after) - t_kill, 3)
    gaps = [round(b[0] - a[0], 3) for a, b in zip(arrivals, arrivals[1:])]
    dumps = [x for x in telemetry.load_flight_dumps(os.path.join(d, "flight"))
             if "error" not in x]
    off_card = _off_card(dumps)
    log(f"  [17a] chaos --mp --rounds {CHAOS_ROUNDS} --num-workers 3: kills "
        f"(target, after round, pid) {kills}; coordinator incarnations "
        f"{summary['coordinator_incarnations']}; rounds_resumed "
        f"{summary['rounds_resumed']}; rounds {summary['rounds_run']}, "
        f"evicted {summary['evicted']}, weighted_acc "
        f"{summary['weighted_acc']}; flight dumps {len(dumps)} "
        f"({sorted(str(x.get('role')) for x in dumps)}), missing "
        f"{summary['flight_missing']}; children off the card {off_card}; "
        f"events {summary['events']}; time to recover (s from the kill to "
        f"the next round's record) {recover}, record gaps {gaps} s; "
        f"{took:.2f} s; {card()}")
    if not (kills and [k[0] for k in kills]
            == ["worker:1", "coordinator", "broker"]
            and [k[1] for k in kills] == [1, 2, 3]
            and all(k[2] for k in kills)
            and summary["coordinator_incarnations"] == 2
            and summary["rounds_resumed"] >= 1
            and summary["rounds_run"] == CHAOS_ROUNDS
            and not summary["flight_missing"] and len(dumps) == 8
            and not off_card):
        brief = {k: v for k, v in summary.items() if k != "records"}
        raise AssertionError(f"17a: kills {kills}, summary {brief}, off "
                             f"the card {off_card}")
    return {"kills": kills, "seconds": took, "recover_s": recover}


def postmortem_path(kills) -> None:
    """17b: ``postmortem D/flight --wal-dir D/ckpt --format json`` through
    ``cli.main`` over 17a's run: it exits 0, names the killed
    coordinator's role and pid, and its committed rounds are the WAL's."""
    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.ckpt import RoundWal

    d = CKPT["chaos"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["postmortem", os.path.join(d, "flight"), "--wal-dir",
                  os.path.join(d, "ckpt"), "--format", "json"])
    report = json.loads(out.getvalue())
    wal = [e["round"] for e in RoundWal(os.path.join(d, "ckpt")).load()]
    pid = next(k[2] for k in kills if k[0] == "coordinator")
    named = [p for p in report["processes"] if p.get("pid") == pid]
    seen = [(p["pid"], p["role"], p["trigger"], p["last_round_seen"])
            for p in named]
    log(f"  [17b] postmortem: last committed round "
        f"{report['last_committed_round']}, committed rounds "
        f"{report['committed_rounds']}, in flight "
        f"{report['rounds_in_flight']}, {report['process_count']} "
        f"processes, triggers {report['crash_triggers']}; the killed "
        f"coordinator (pid, role, trigger, last round seen): "
        f"{seen}; WAL rounds {wal}")
    if not (named and named[0]["role"] == "coordinator"
            and wal == list(range(CHAOS_ROUNDS))
            and report["committed_rounds"] == len(wal)
            and report["last_committed_round"] == wal[-1]
            and report["rounds_in_flight"] == []):
        raise AssertionError(f"17b: report {report}, WAL {wal}")


def _off_card(dumps) -> list:
    """(pid, role, backend) of every child but the broker (which holds no
    tensor) whose dump lacks ``--backend gpu`` or a ``cuda`` device event."""
    off = []
    for x in dumps:
        argv = x.get("argv", [])
        on_card = any(e.get("kind") == "device" and e.get("device") == "cuda"
                      for e in x.get("events", []))
        backend = (argv[argv.index("--backend") + 1]
                   if "--backend" in argv else None)
        if x.get("role") != "broker" and not (on_card and backend == "gpu"):
            off.append((x.get("pid"), x.get("role"), backend))
    return off


def chaos_tree_async_path() -> dict:
    """17c: ``chaos --tree-async --lock-witness --rounds 6 --num-workers 3``
    through ``cli.main`` on the card: two fleets of the port's command line
    (a broker, 3 workers, 2 aggregators and the asynchronous coordinator
    at K = 2 through the aggregators' slice buffers, config #1's MLP with
    the soak's DP on ``mnist_tiny``), every process under the lock
    witness.  In the faulted fleet aggregator 0 is SIGKILLed after
    aggregation 2 and left dead, the broker after aggregation 4 and
    respawned on its port; the oracle fleet runs with no kill.  The
    command's own gate passes (it exits 1 otherwise): the failover fired,
    no contribution folded twice, every re-homed device in the ledger, the
    postmortem names the dead aggregator and its dump is on disk, the loss
    tails agree, and the witness reports saw lock traffic with no
    inversion and no unguarded access.  Then: the kills with their pids,
    the killed aggregator's dump names its role, and every child but the
    brokers ran on the card."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    d = CKPT["chaos_tree"]
    arrivals = []                  # (host seconds, aggregation) per record
    log_rec = cli._chaos_log

    def timed(rec):
        arrivals.append((time.perf_counter(), rec["aggregation"]))
        log_rec(rec)

    t0 = time.perf_counter()
    cli._chaos_log = timed
    try:
        summary = cli.main(["chaos", "--tree-async", "--lock-witness",
                            "--rounds", str(CHAOS_ROUNDS), "--num-workers",
                            "3", "--workdir", d])
    finally:
        cli._chaos_log = log_rec
    took = time.perf_counter() - t0
    # The faulted fleet streams first; the oracle's records start again
    # at aggregation 0.
    split = next((i for i in range(1, len(arrivals))
                  if arrivals[i][1] < arrivals[i - 1][1]), len(arrivals))
    faulted = arrivals[:split]
    kills = [(k["target"], k["fired_after_round"], k.get("pid"))
             for k in summary["kills"]]
    # Time to recover: from the kill (as its aggregation's record is read)
    # to the next aggregation's record.
    recover = {}
    for target, after, _ in kills:
        t_kill = next(t for t, a in faulted if a == after)
        recover[target] = round(next(t for t, a in faulted
                                     if t > t_kill and a > after) - t_kill, 3)
    dumps = {fleet: [x for x in telemetry.load_flight_dumps(
                         os.path.join(d, fleet, "flight"))
                     if "error" not in x]
             for fleet in ("faulted", "oracle")}
    off_card = _off_card(dumps["faulted"] + dumps["oracle"])
    agg_pid = next(k[2] for k in kills if k[0] == "aggregator:0")
    victim = [x.get("role") for x in dumps["faulted"]
              if x.get("pid") == agg_pid]
    lw = summary["lock_witness"]
    witness = {k: lw[k] for k in ("reports", "acquires", "guarded_ops",
                                  "inversions", "unguarded")}
    log(f"  [17c] chaos --tree-async --lock-witness --rounds {CHAOS_ROUNDS} "
        f"--num-workers 3: kills (target, after aggregation, pid) {kills}; "
        f"witness {witness}; failover_fired {summary['failover_fired']}, "
        f"agg_failovers {summary['agg_failovers']}, double_folds "
        f"{summary['double_folds']} of {summary['folded_keys_total']} keys, "
        f"re-homed devices {summary['rehomed_devices']} (attributed "
        f"{summary['rehomed_attributed']}); aggregations "
        f"{summary['aggregations_run']} faulted, "
        f"{summary['oracle_aggregations_run']} oracle; tail loss "
        f"{summary['final_loss']} vs {summary['oracle_final_loss']}, gap "
        f"{summary['loss_gap']}; flight dumps {len(dumps['faulted'])} + "
        f"{len(dumps['oracle'])} (the killed aggregator's: {victim}), "
        f"missing {summary['flight_missing']}; children off the card "
        f"{off_card}; time to recover (s from the kill to the next "
        f"aggregation's record) {recover}; {took:.2f} s; {card()}")
    if not (kills and [k[0] for k in kills] == ["aggregator:0", "broker"]
            and [k[1] for k in kills] == [2, 4]
            and all(k[2] for k in kills)
            and summary["failover_fired"] and summary["double_folds"] == 0
            and summary["rehomed_attributed"]
            and summary["postmortem_attributed"]
            and not summary["flight_missing"]
            and victim == ["aggregator0"]
            and lw["reports"] >= 1 and lw["acquires"] >= 1
            and lw["inversions"] == 0 and lw["unguarded"] == 0
            and summary["aggregations_run"] == CHAOS_ROUNDS
            and len(recover) == 2 and not off_card):
        brief = {k: v for k, v in summary.items() if k != "records"}
        raise AssertionError(f"17c: kills {kills}, summary {brief}, off "
                             f"the card {off_card}, victim {victim}")
    return {"kills": kills, "seconds": took, "recover_s": recover,
            "witness": witness}


def chaos_phase(before_17c=None) -> dict:
    """Phase 17: the chaos soaks on the card (17a ``chaos --mp``, 17b
    ``postmortem``, 17c ``chaos --tree-async --lock-witness``); the
    in-process, secure, ``--agg`` and ``--async`` soaks run in the CPU
    tests.  ``before_17c`` is called after 17b (also when 17a or 17b
    raised), before 17c starts."""
    try:
        t0 = time.perf_counter()
        mp = chaos_mp_path()
        log(f"  17a in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        postmortem_path(mp["kills"])
        log(f"  17b in {time.perf_counter() - t0:.2f} s")
    finally:
        if before_17c is not None:
            before_17c()
    t0 = time.perf_counter()
    tree = chaos_tree_async_path()
    log(f"  17c in {time.perf_counter() - t0:.2f} s")
    return {"mp": mp, "tree_async": tree}


# ------------------------------------------------------------ phase 18
SHARD_TP = 2               # 18a: two positions of the (model,) axis ...
SHARD_PARTIALS = 2         # ... on the one card; the root's 2 partials
CKPT_ROUNDS, CKPT_WORKERS = 4, 2   # 18c: run_ckpt_soak's own defaults


def topk8_wire(shapes, slots):
    """A drawn topk8 contribution (``sparse_batch``'s per-slot int64
    indices, int8 values and scale) as the wire tree a topk8 frame
    carries."""
    from colearn_federated_learning_tpu_torch.utils import trees

    return trees.unflatten(shapes, [
        {"i": idx.astype(np.int32), "v": vals,
         "n": np.int64(np.size(ref)), "s": np.float32(scale)}
        for (idx, vals, scale), ref in zip(slots, trees.leaves(shapes))])


def _fold_all(F, inputs, **kw):
    """A ``StreamingFolder(**kw)`` over 18a's contributions in cohort order,
    dense batches of at most ``FOLD_ROWS`` rows (9a's staging buffer
    holds them); returns ``(its mean, the launches its fold made)``."""
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)

    f = StreamingFolder(inputs.shapes, order=inputs.order, **kw)
    f._fold_batch_max = FOLD_ROWS
    for meta, wire in inputs.sparse + inputs.dense:
        f.add(dict(meta), wire)
    for key, tw, tree, ls in inputs.partials:
        f.add_partial(key, tw, tree, ls)
    F.reset_launches()
    mean = f.mean()
    torch.cuda.synchronize()
    return mean, dict(F.launches)


def shard_inputs():
    """18a's inputs: BERT-base's server params (9a's layout) and their
    placement over ``SHARD_TP`` positions on the one card, 9a's draws (10
    topk8 contributions from seed 91, 10 dense rows from seed 93, the
    first two of them again as the root's partials) and the cohort
    order."""
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees

    params = bert_params()
    # 9a's device key, so the replicated fold shares 9a's kernel and its
    # staging buffer.
    dev = torch.device("cuda")
    placement = partition.make_server_placement(
        params, SHARD_TP, "model", main_path_config().model.name,
        devices=[dev] * SHARD_TP)
    if placement is None:
        raise AssertionError("18a: BERT-base's params did not shard")
    shapes = placement.shapes_tree()
    sizes = [int(np.asarray(l).size) for l in trees.leaves(params)]
    t0 = time.perf_counter()
    sparse = [({"client_id": f"s{r}", "weight": float(w),
                "mean_loss": 0.5 + 0.01 * r, "compress": "topk8"},
               topk8_wire(shapes, slots))
              for r, (w, slots) in enumerate(
                  sparse_batch(sizes, FOLD_ROWS, True, 91))]
    g = torch.Generator(device="cuda").manual_seed(93)
    rng = np.random.default_rng(93)
    dense = []
    for r in range(FOLD_ROWS):
        flat = torch.randn(sum(sizes), generator=g, device="cuda")
        dense.append(({"client_id": f"d{r}",
                       "weight": float(rng.uniform(1.0, 300.0)),
                       "mean_loss": 0.4, "compress": "none"},
                      trees.unflatten(shapes, [
                          part.reshape(np.shape(ref)) for part, ref in zip(
                              np.split(flat.cpu().numpy(),
                                       np.cumsum(sizes)[:-1]),
                              trees.leaves(shapes))])))
    partials = [(f"p{i}", 3.5 + i, dense[i][1], 1.25 + i)
                for i in range(SHARD_PARTIALS)]
    return SimpleNamespace(
        params=params, dev=dev, placement=placement, shapes=shapes,
        sizes=sizes, sparse=sparse, dense=dense, partials=partials,
        order=([m["client_id"] for m, _ in sparse + dense]
               + [p[0] for p in partials]),
        draw_s=time.perf_counter() - t0)


def shard_kernel_rows(F, inputs) -> dict:
    """18a's kernels at the per-shard slot layout (one slot per distinct
    shard): ``fold_sparse`` over the 10 topk8 contributions and
    ``fold_dense`` over the root's 2 partials, each bitwise its plain
    version there, then timed per launch as 9a times them (``sparse_row``,
    ``dense_row``) beside its plain version, its library call and its
    bound."""
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)

    placement = inputs.placement
    stager = StreamingFolder(inputs.shapes, placement=placement,
                             device_fold=True, device=inputs.dev)
    kernel = F.get_kernel([int(np.prod(shape, dtype=np.int64))
                           for group in stager._slot_layout()
                           for shape in group], inputs.dev)
    if len(kernel.sizes) <= len(inputs.sizes):
        raise AssertionError("18a: the slot layout is not per shard")
    st = kernel.stage_sparse([
        (np.float32(m["weight"]), stager._stage_topk_raw(w).slots)
        for m, w in inputs.sparse])
    err_s = bits_equal("18a fold_sparse at the shard layout",
                       kernel.fold_sparse_staged(None, st),
                       plain_sparse(F, kernel, st, None))
    x = kernel.stage_dense([stager._dense_slots(placement.slice_tree(tree))
                            for _, _, tree, _ in inputs.partials])
    got = kernel.fold_dense_staged(None, x)
    err_d = bits_equal("18a fold_dense at the shard layout", got,
                       F.fold_dense_reference(torch.empty_like(got), x,
                                              True))
    acc = torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
    srow, _, _ = sparse_row(F, kernel, st, acc, FOLD_ROWS)
    rows = {"fold_sparse": {**srow, "max_abs_err": err_s},
            "fold_dense": {**dense_row(F, kernel, x), "max_abs_err": err_d}}
    shape = {"fold_sparse": "per topk8 contribution",
             "fold_dense": f"{SHARD_PARTIALS} partials per launch"}
    for name, r in rows.items():
        log(f"  [18a] {name} at the tp = {SHARD_TP} slot layout "
            f"({len(kernel.sizes)} slots, {shape[name]}): "
            f"{r['ms'] * 1e3:.2f} us device per launch "
            f"({r['bound_ms'] / r['ms']:.1%} of bound "
            f"{r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}); plain "
            f"{r['plain_ms'] * 1e3:.2f} us; library "
            f"{r['library_ms'] * 1e3:.2f} us; bitwise its plain version; "
            + json.dumps({"label": f"tp{SHARD_TP}", "name": name, **r}))
    return rows


def sharded_fold_path(F, inputs) -> tuple[dict, dict]:
    """18a: the sharded server on the card at BERT-base's server params
    over a ``(model,)`` placement of two positions on the one card.  The
    contributions fold through ``StreamingFolder(placement=...,
    device_fold=True)`` (the B4 kernels at the per-shard slot layout),
    and the assembled mean is bitwise the replicated device fold's and
    the placed host fold's.  Then one FedAdam ``server_update`` over the
    shards (the params and both moments sharded) is bitwise the
    replicated step, the downlink frame of the placed params is
    byte-equal to the replicated one and moves
    ``comm.gather_bytes_avoided_total`` by exactly ``tree_gather_avoided``,
    and ``bytes_per_chip`` is printed.  Returns (the launches of the
    placed fold, numbers)."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.comm.downlink import (
        DownlinkEncoder)
    from colearn_federated_learning_tpu_torch.fed import strategies
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees

    placement, dev, shapes = inputs.placement, inputs.dev, inputs.shapes
    n = len(inputs.sizes)
    t0 = time.perf_counter()
    (m_shd, tw, ls), launches = _fold_all(F, inputs, placement=placement,
                                          device_fold=True, device=dev)
    t_shd = time.perf_counter() - t0
    want = {"fold_sparse": FOLD_ROWS, "fold_dense": 2}
    if launches != want:
        raise AssertionError(f"18a: launches {launches}, want {want}")
    got = _leaf_bytes(partition.host_tree(m_shd))
    t0 = time.perf_counter()
    (m_rep, tw_r, ls_r), _ = _fold_all(F, inputs, device_fold=True,
                                       device=dev)
    if _leaf_bytes(m_rep) != got or (tw_r, ls_r) != (tw, ls):
        raise AssertionError("18a: the placed fold differs from the "
                             "replicated device fold")
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    (m_host, tw_h, ls_h), _ = _fold_all(F, inputs, placement=placement)
    if (_leaf_bytes(partition.host_tree(m_host)) != got
            or (tw_h, ls_h) != (tw, ls)):
        raise AssertionError("18a: the placed fold differs from the host "
                             "fold")
    t_host = time.perf_counter() - t0
    del m_rep, m_host
    log(f"  [18a] BERT-base over {SHARD_TP} positions on one card: "
        f"{n} leaves, sharded fraction {placement.sharded_fraction():.4f}; "
        f"{FOLD_ROWS} topk8 + {FOLD_ROWS} dense + {SHARD_PARTIALS} partials "
        f"(drawn in {inputs.draw_s:.2f} s): the placed device fold "
        f"({t_shd:.2f} s, launches {launches}) bitwise the replicated "
        f"device fold ({t_rep:.2f} s) and the placed host fold "
        f"({t_host:.2f} s), with 18c's fleets running beside them")

    # One FedAdam server step, sharded against replicated.
    fed = dataclasses.replace(main_path_config().fed, strategy="fedadam",
                              server_lr=0.01)
    rep = strategies.init_server_state(
        {str(i): torch.from_numpy(np.array(l)).to(dev)
         for i, l in enumerate(trees.leaves(inputs.params))}, fed)
    strategies.server_update(rep, {
        str(i): torch.from_numpy(np.asarray(l)).to(dev)
        for i, l in enumerate(trees.leaves(partition.host_tree(m_shd)))},
        fed)
    sharded = strategies.init_server_state(
        placement.flatten(placement.shard(inputs.params)), fed)
    strategies.server_update(sharded, placement.flatten(m_shd), fed)
    torch.cuda.synchronize()
    for part in ("params", "opt_m", "opt_v"):
        a = partition.host_tree(placement.unflatten(getattr(sharded, part)))
        b = trees.unflatten(shapes, [getattr(rep, part)[str(i)]
                                     for i in range(n)])
        if _leaf_bytes(a) != _leaf_bytes(partition.host_tree(b)):
            raise AssertionError(f"18a: the sharded step's {part} differs "
                                 "from the replicated step's")
    # The downlink frame and the gather it avoided.
    placed = placement.unflatten(sharded.params)
    avoided = partition.tree_gather_avoided(placed)
    counter = telemetry.get_registry().counter(
        "comm.gather_bytes_avoided_total")
    before = counter.value
    body_shd = bytes(DownlinkEncoder("none").encode_round(1, placed)[0])
    moved = counter.value - before
    body_rep = bytes(DownlinkEncoder("none").encode_round(1, trees.unflatten(
        shapes, [rep.params[str(i)] for i in range(n)]))[0])
    if body_shd != body_rep or moved != avoided or not avoided:
        raise AssertionError(f"18a: frames equal {body_shd == body_rep}, "
                             f"counter moved {moved} of {avoided}")
    per_chip = partition.bytes_per_chip(strategies.ServerState(
        params=placed, opt_m=placement.unflatten(sharded.opt_m),
        opt_v=placement.unflatten(sharded.opt_v)))
    numbers = {"leaves": n, "gather_bytes_avoided": avoided,
               "bytes_per_chip": per_chip,
               "replicated_state_bytes": 3 * 4 * sum(inputs.sizes),
               "frame_bytes": len(body_shd),
               "fold_s": {"placed_device": t_shd, "replicated_device": t_rep,
                          "placed_host": t_host}}
    log(f"  [18a] FedAdam step over the shards bitwise the replicated step "
        f"(params, opt_m, opt_v); downlink frame of {len(body_shd)} bytes "
        f"byte-equal to the replicated one, comm.gather_bytes_avoided_total "
        f"+{moved} (tree_gather_avoided {avoided}); bytes_per_chip "
        f"{per_chip} (the replicated state {numbers['replicated_state_bytes']}"
        f"); {card()}")
    return launches, numbers


def fallback_path() -> None:
    """18b: ``make_server_placement`` falls back, counted.  BERT-base at tp
    = 2 with the default positions (the host's cards): one card, so None
    under ``insufficient_devices``.  Config #1's MLP at tp = 3 on three
    positions of the card: 200, 200 and 10 do not divide by 3, every leaf
    replicates, so None under ``rules_matched_nothing``."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.fed import setup
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    reg = telemetry.get_registry()

    def count(reason):
        return reg.snapshot().get(
            f"fed.mesh_fallback_total{{reason={reason}}}", 0)

    bert = bert_params()
    before = count("insufficient_devices")
    pl = partition.make_server_placement(bert, SHARD_TP, "model", "bert")
    cards = torch.cuda.device_count()
    if (pl is None) != (cards < SHARD_TP) or (
            cards < SHARD_TP and count("insufficient_devices") != before + 1):
        raise AssertionError(f"18b: {cards} cards, placement {pl}")
    mlp = setup.init_global_params(get_config("mnist_mlp_fedavg"), "cuda")
    before_r = count("rules_matched_nothing")
    dev = torch.device("cuda", 0)
    pl3 = partition.make_server_placement(mlp, 3, "model", "mlp",
                                          devices=[dev] * 3)
    if pl3 is not None or count("rules_matched_nothing") != before_r + 1:
        raise AssertionError(f"18b: the MLP at tp = 3 gave {pl3}")
    log(f"  [18b] BERT-base at tp = {SHARD_TP} on {cards} card(s): "
        f"placement {'none' if pl is None else pl.n_devices}, "
        f"insufficient_devices {before} -> {count('insufficient_devices')}; "
        f"config #1's MLP at tp = 3: none, rules_matched_nothing "
        f"{before_r} -> {count('rules_matched_nothing')}")


def chaos_ckpt_path() -> dict:
    """18c: ``chaos --ckpt`` (the kill leg, JAX's defaults: 4 rounds, 2
    workers, tp 2 -> 1, 300 ms of slow I/O per shard file) through
    ``cli.main``: two fleets of the port's command line (a broker and 2
    workers on the card, the ``--ckpt-stream`` coordinator on the CPU
    with 8 forced host positions, since its tp = 2 placement needs two
    positions and the machine has one card), config #1's MLP.  The
    faulted coordinator is SIGKILLed while a save is in flight and
    relaunched with ``--resume --tp-size 1``; the command's gate passes
    (it exits 1 otherwise): the kill mid-save, the resume at the last
    committed step with its digest, ``resharded`` >= 1, the loss tail
    against the kill-free oracle, the postmortem naming the coordinator,
    no dump missing.  Then: the workers ran on the card and every
    coordinator incarnation on the CPU."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    d = CKPT["chaos_ckpt"]
    arrivals = []                  # (wall seconds, round) per record line
    log_rec = cli._chaos_log

    def timed(rec):
        arrivals.append((time.time(), rec["round"]))
        log_rec(rec)

    t0 = time.perf_counter()
    cli._chaos_log = timed
    try:
        summary = cli.main(["chaos", "--ckpt", "--rounds", str(CKPT_ROUNDS),
                            "--num-workers", str(CKPT_WORKERS), "--workdir",
                            d])
    finally:
        cli._chaos_log = log_rec
    took = time.perf_counter() - t0
    kill = summary["kill"]
    after = [t for t, r in arrivals if t > kill["at"]]
    recover = round(after[0] - kill["at"], 3) if after else None
    dumps = [x for x in telemetry.load_flight_dumps(
        os.path.join(d, "faulted", "flight")) if "error" not in x]
    off = _off_card(dumps)
    workers = [x for x in dumps
               if str(x.get("role", "")).startswith("worker")]
    log(f"  [18c] chaos --ckpt: killed pid {kill.get('pid')} mid-save of "
        f"{summary['killed_gen']} (mid_save {summary['killed_mid_save']}); "
        f"committed step {summary['committed_step']}, resumed at round "
        f"{summary['resume_round']} with digest ok {summary['digest_ok']}, "
        f"resharded {summary['resharded_resumes']}; rounds "
        f"{summary['rounds_run']} faulted, {summary['oracle_rounds_run']} "
        f"oracle; tail loss {summary['final_loss']} vs "
        f"{summary['oracle_final_loss']}; postmortem attributed "
        f"{summary['postmortem_attributed']}, missing dumps "
        f"{summary['flight_missing']}; {len(dumps)} dumps, off the card "
        f"{off}; {recover} s from the kill to the resumed round's record; "
        f"the soak {took:.2f} s; {card()}")
    if not (summary["killed_mid_save"] and summary["resharded_resumes"] >= 1
            and recover is not None and len(workers) == CKPT_WORKERS
            and off and {role for _, role, _ in off} == {"coordinator"}
            and {b for _, _, b in off} == {"cpu"}):
        brief = {k: v for k, v in summary.items() if k != "records"}
        raise AssertionError(f"18c: summary {brief}, off the card {off}")
    return {"seconds": took, "recover_s": recover,
            "committed_step": summary["committed_step"],
            "killed_gen": summary["killed_gen"]}


def sharded_phase(F) -> tuple[dict, dict]:
    """Phase 18: the sharded server (18a the placed fold, step and
    downlink on the card; 18b the fallbacks; 18c ``chaos --ckpt``).  18a's
    kernels are timed first, alone; then 18c's soak (processes that do
    little on the card) runs on a thread beside 18a's folds and 18b.
    Returns (its paths' launches, 18a's timing rows)."""
    t0 = time.perf_counter()
    inputs = shard_inputs()
    rows = shard_kernel_rows(F, inputs)
    log(f"  18a's inputs and kernels in {time.perf_counter() - t0:.2f} s")
    soak = Beside("18c", chaos_ckpt_path)
    try:
        t0 = time.perf_counter()
        launches, numbers = sharded_fold_path(F, inputs)
        del inputs
        log(f"  18a's folds, step and downlink in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        fallback_path()
        log(f"  18b in {time.perf_counter() - t0:.2f} s")
    finally:
        ckpt = soak.join()
    log(f"  18c in {soak.s:.2f} s (beside 18a's folds and 18b)")
    numbers["18c"] = ckpt
    log("phase 18 numbers " + json.dumps(numbers))
    return {"sharded_fold": launches}, rows


# ------------------------------------------------------------ phase 19
MESH_CKPT_ROUNDS = 2       # 19: round 0 saved, round 1 resumed


def _host_state(learner) -> dict:
    """A learner's params, server control and variate rows as host copies
    (the rows are host tensors already)."""
    s = learner.server_state
    out = {f"params/{k}": v.detach().cpu().clone()
           for k, v in s.params.items()}
    out.update({f"control/{k}": v.detach().cpu().clone()
                for k, v in (s.control or {}).items()})
    if learner.variates is not None:
        out.update({f"variates/{i}": r.clone()
                    for i, r in enumerate(learner.variates.rows)})
    return out


def mesh_resume_phase(A, F) -> dict:
    """19: item 15b on the card.  Config #2 with ``--strategy scaffold
    --momentum 0`` at cohort 10 (7a's cut) on a world-1 NCCL client mesh
    (``init_device_mesh("cuda", (1,), ("clients",))`` from a FileStore):
    an uninterrupted 2-round run; a run with ``checkpoint_dir`` that saves
    after round 0; a fresh mesh learner that restores the step and runs
    round 1.  Its params, server control and every variate row must equal
    the uninterrupted run's bit for bit, and the step's leaves must have
    the one-device learner's paths and shapes.  Prints the save and
    restore seconds and the step's MB.  Returns its launches (none of the
    kernels runs on the CNN)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from colearn_federated_learning_tpu_torch.ckpt import (
        RoundCheckpointer, streaming)
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    base = get_config("cifar10_cnn_fedavg")
    base = base.replace(fed=dataclasses.replace(
        base.fed, strategy="scaffold", momentum=0.0, cohort_size=CNN_COHORT,
        rounds=MESH_CKPT_ROUNDS))
    A.reset_launches()
    F.reset_launches()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cfg = base.replace(run=dataclasses.replace(
            base.run, checkpoint_dir=os.path.join(tmp, "ckpt")))
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,),
                                    mesh_dim_names=("clients",))
            t0 = time.perf_counter()
            learner = FederatedLearner(base, mesh=mesh)
            learner.fit(rounds=MESH_CKPT_ROUNDS)
            straight = _host_state(learner)
            straight_s = time.perf_counter() - t0
            del learner
            learner = FederatedLearner(cfg, mesh=mesh)
            learner.fit(rounds=1)
            save_s = learner.history[-1]["phase_checkpoint_s"]
            del learner
            learner = FederatedLearner(cfg, mesh=mesh)
            t0 = time.perf_counter()
            step = learner.restore_checkpoint()
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            learner.fit()
            resumed = _host_state(learner)
            rounds = [r["round"] for r in learner.history]
            del learner
        finally:
            dist.destroy_process_group()
        table = RoundCheckpointer(cfg.run.checkpoint_dir).leaf_table(1)
        one = FederatedLearner(base)
        want = [(path, list(leaf.shape)) for path, leaf in
                streaming.flatten_state(one._checkpoint_state())]
        del one
    launches = {**A.launches, **F.launches}
    mb = sum(4 * math.prod(r["shape"]) for r in table) / 1e6
    differ = [k for k in straight if not torch.equal(straight[k], resumed[k])]
    got = [(r["path"], r["shape"]) for r in table]
    log(f"  [19] config #2 SCAFFOLD on a world-1 NCCL mesh (cohort 20 -> "
        f"10): uninterrupted {MESH_CKPT_ROUNDS} rounds {straight_s:.2f} s; "
        f"saved after round 0 in {save_s:.3f} s ({mb:.1f} MB, {len(table)} "
        f"leaves, client_c {table[-1]['shape'][0]} slots); restored step "
        f"{step} in {restore_s:.3f} s; resumed rounds {rounds}; "
        f"{len(straight)} tensors against the uninterrupted run, "
        f"{len(differ)} differ; leaf shapes the one-device learner's: "
        f"{got == want}; launches {launches}; {card()}")
    if differ or step != 1 or rounds != [0, 1] or got != want:
        raise AssertionError(f"19: the resumed mesh run differs ({differ[:4]}"
                             f", step {step}, rounds {rounds}) or the step's "
                             f"leaves are not the one-device learner's")
    if any(launches.values()):
        raise AssertionError(f"19: a kernel launched on the CNN: {launches}")
    return launches


# ------------------------------------------------------------ phase 20
FLEET_DEVICES = 1_000_000   # 20a: the fleet, the cohort and its chunks
FLEET_COHORT = 1024
FLEET_CHUNK = 256
FLEET_ROUNDS = 3
FLEET_FAULTS = [            # count 0: unlimited, each on 2 % of the keys
    {"kind": "drop_request", "op": "train", "probability": 0.02,
     "count": 0},
    {"kind": "delay", "op": "train", "probability": 0.02, "ms": 1000.0,
     "count": 0},
    {"kind": "corrupt_payload", "op": "train", "probability": 0.02,
     "count": 0}]
FLEET_ASYNC_ROUNDS = 6      # 20c's aggregations


def _fleet_expected(plan_path: str) -> list:
    """20a's rounds replayed on the host from the command's defaults: each
    round's traffic cohort and the plan's firings on it (the plan's
    probability gate is a hash of its seed and the key, so a replay fires
    as the run did), and the devices that must complete (not dropped, not
    corrupted, not delayed past the whole deadline)."""
    from colearn_federated_learning_tpu_torch import fleetsim
    from colearn_federated_learning_tpu_torch.faults.plan import FaultPlan

    plan = FaultPlan.load(plan_path)
    traffic = fleetsim.TrafficModel(fleetsim.TrafficSpec(), FLEET_DEVICES)
    kinds = ("drop_request", "delay", "corrupt_payload")
    out = []
    for r in range(FLEET_ROUNDS):
        ids = traffic.sample_cohort(r, FLEET_COHORT)
        fired = {k: 0 for k in kinds}
        completed = trained = 0
        for d in ids:
            hit = {f.kind for f in plan.match(str(int(d)), r, "train",
                                              kinds=kinds, site="server")}
            for k in hit:
                fired[k] += 1
            trained += "drop_request" not in hit
            completed += not hit
        out.append(dict(cohort=len(ids), trained=trained,
                        completed=completed, **fired))
    return out


def _fleet_prices(compress: str) -> tuple[int, int]:
    """The shape-only frame prices of 20a's MLP (32 -> 64 -> 64 -> 10):
    the full downlink frame and the ``compress`` uplink train frame."""
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    dims = [32, 64, 64, 10]
    zeros = {f"Dense_{i}": {"kernel": np.zeros((a, b), np.float32),
                            "bias": np.zeros((b,), np.float32)}
             for i, (a, b) in enumerate(zip(dims, dims[1:]))}
    wire, meta = compression.compress_delta(zeros, compress)
    return (wire_frame_length(zeros, {"round": 0, "down": "full"}),
            wire_frame_length(wire, {"round": 0, "op": "train", **meta}))


def fleet_cli_path(workdir: str) -> dict:
    """20a: ``fleetsim --devices 1000000 --cohort 1024 --chunk 256 --rounds
    3 --compress topk8`` through ``cli.main`` with ``--trace-dir`` and a
    fault plan of ``drop_request``, ``delay`` (the whole deadline) and
    ``corrupt_payload``, each unlimited at 2 %.  Each round's cohort,
    firings, trained and completed devices equal the host's replay of the
    plan on the traffic model's cohorts; the summary's counts are the
    records' sums and ``fault.injected_total`` moved by them; every
    record's bytes are the shape-only prices times its devices; the loss
    is finite; the trace holds one ``train_chunk`` span per chunk."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    plan_path = os.path.join(workdir, "fleet_plan.json")
    with open(plan_path, "w") as f:
        json.dump({"faults": FLEET_FAULTS}, f)
    reg = telemetry.get_registry()
    kinds = ("drop_request", "delay", "corrupt_payload")

    def injected():
        return {k: reg.counter("fault.injected_total",
                               labels={"kind": k}).value for k in kinds}

    before = injected()
    argv = ["fleetsim", "--devices", str(FLEET_DEVICES), "--cohort",
            str(FLEET_COHORT), "--chunk", str(FLEET_CHUNK), "--rounds",
            str(FLEET_ROUNDS), "--compress", "topk8", "--trace-dir", workdir,
            "--fault-plan", plan_path]
    t0 = time.perf_counter()
    (summary, err) = _stderr_of(lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in err.splitlines()
               if line.startswith('{"train_loss"')]
    want = _fleet_expected(plan_path)
    down, up = _fleet_prices("topk8")
    moved = {k: v - before[k] for k, v in injected().items()}
    bad = []
    for rec, w in zip(records, want):
        got = dict(cohort=rec["cohort"], trained=rec["clients_trained"],
                   completed=int(rec["completed"]),
                   drop_request=rec["dropped"], delay=rec["straggled"],
                   corrupt_payload=rec["corrupted"])
        if got != w:
            bad.append((rec["round"], got, w))
        if (rec["bytes_down_est"] != rec["clients_trained"] * down
                or rec["bytes_up_est"] != rec["clients_trained"] * up
                or not math.isfinite(rec["train_loss"])):
            bad.append((rec["round"], "bytes or loss", rec))
    sums = {k: sum(w[k] for w in want) for k in kinds}
    doc = telemetry.load_trace(os.path.join(workdir, "fleetsim_trace.json"))
    chunks = sum(s.name == "train_chunk" for s in telemetry.trace_spans(doc))
    want_chunks = sum(math.ceil(w["cohort"] / FLEET_CHUNK) for w in want)
    secs = [r["round_time_s"] for r in records]
    log(f"  [20a] fleetsim {FLEET_DEVICES} devices, cohort {FLEET_COHORT} "
        f"in chunks of {FLEET_CHUNK}, {FLEET_ROUNDS} rounds, topk8: "
        f"s/round {[round(t, 3) for t in secs]}, clients/s "
        f"{summary['clients_per_sec']:.1f}; trained "
        f"{summary['clients_trained']}, completed "
        f"{[int(r['completed']) for r in records]}, firings {sums} "
        f"(counted {moved}); bytes/round down "
        f"{summary['bytes_down_per_round']:.0f} up "
        f"{summary['bytes_up_per_round']:.0f} (prices {down}, {up}); loss "
        f"{summary['train_loss']:.6f}; train_chunk spans {chunks}; path "
        f"{wall:.2f} s; {card()}")
    if (bad or len(records) != FLEET_ROUNDS or moved != sums
            or summary["clients_trained"] != sum(w["trained"] for w in want)
            or {k: summary[k] for k in ("dropped", "straggled", "corrupted")}
            != {"dropped": sums["drop_request"], "straggled": sums["delay"],
                "corrupted": sums["corrupt_payload"]}
            or chunks != want_chunks):
        raise AssertionError(f"20a: {bad[:3]}, firings {moved} against "
                             f"{sums}, chunks {chunks} against {want_chunks}")
    RECORDS["20a"] = (records, plan_path)
    return dict(s_round=secs, clients_per_sec=summary["clients_per_sec"])


FLEET_OBSERVED_ROUNDS = 2      # 20a with --learn-observe: its first rounds


def fleet_observe_path() -> dict:
    """20a with ``--learn-observe`` (its first 2 rounds, the same fault
    plan, no trace): every record carries the observatory's keys with
    ``conv_cohort_skew`` and ``conv_norm_p90`` (the population's home
    classes and the devices' norms), the second ``conv_cos_prev`` too,
    and apart from its ``conv_*`` keys and times each record is 20a's,
    bit for bit: observing changes nothing of the round.  Its seconds per
    round are printed beside 20a's."""
    from colearn_federated_learning_tpu_torch import cli

    plain, plan_path = RECORDS["20a"]
    argv = ["fleetsim", "--devices", str(FLEET_DEVICES), "--cohort",
            str(FLEET_COHORT), "--chunk", str(FLEET_CHUNK), "--rounds",
            str(FLEET_OBSERVED_ROUNDS), "--compress", "topk8",
            "--fault-plan", plan_path, "--learn-observe"]
    t0 = time.perf_counter()
    (_, err) = _stderr_of(lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in err.splitlines()
               if line.startswith('{"train_loss"')]
    timed = {"round_time_s"}
    bad = []
    for i, (rec, ref) in enumerate(zip(records, plain)):
        want = CONV_KEYS | {"conv_cohort_skew", "conv_cohort_cos_min",
                            "conv_norm_median", "conv_norm_p90",
                            "conv_norm_anomalies"}
        if i:
            want |= {"conv_cos_prev"}
        rest = {k: v for k, v in rec.items()
                if not k.startswith("conv_") and k not in timed}
        if not (want <= set(rec) and rest == {
                k: v for k, v in ref.items() if k not in timed}):
            bad.append((i, sorted(set(rec) - set(ref)), rest))
    secs = [r["round_time_s"] for r in records]
    log(f"  [20a observed] fleetsim ... --rounds {FLEET_OBSERVED_ROUNDS} "
        f"--learn-observe: "
        + json.dumps([{k: r[k] for k in sorted(r) if k.startswith("conv_")}
                      for r in records]))
    log(f"  [20a observed] s/round {[round(t, 3) for t in secs]} against "
        f"20a's {[round(r['round_time_s'], 3) for r in plain]} without "
        f"the flag; records 20a's bit for bit but their conv_* keys; path "
        f"{wall:.2f} s; {card()}")
    if bad or len(records) != FLEET_OBSERVED_ROUNDS:
        raise AssertionError(f"20a observed: {bad[:2]}")
    return dict(s_round=secs)


def fleet_learner_path() -> dict:
    """20b: ``FleetSim.from_learner`` on config #1 (the MLP, f32) on the
    card, from copies of one learner's initial state: the one-chunk
    round equals the engine's ``run_round`` bit for bit (the same draws),
    the 4-chunk round agrees within the CPU test's bound, 1e-5 of the
    round's largest update entry (at least 1e-5): chunked folding
    regroups the f32 sums, so the difference is roundoff of the update."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.fleetsim import FleetSim
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    learner = FederatedLearner(get_config("mnist_mlp_fedavg"))
    start = [p.clone() for p in learner.params.values()]
    n = learner.num_clients
    one = FleetSim.from_learner(learner, chunk_size=n)
    four = FleetSim.from_learner(learner, chunk_size=math.ceil(n / 4))
    secs = {}
    for label, run in (("one chunk", one.run_round),
                       ("4 chunks", four.run_round),
                       ("engine", learner.run_round)):
        t0 = time.perf_counter()
        rec = run()
        torch.cuda.synchronize()
        secs[label] = (round(time.perf_counter() - t0, 3),
                       rec["train_loss"])
    diff1 = max(float((a - b).abs().max()) for a, b in
                zip(one.server_state.params.values(),
                    learner.params.values()))
    diff4 = max(float((a - b).abs().max()) for a, b in
                zip(four.server_state.params.values(),
                    learner.params.values()))
    update = max(float((a - b).abs().max()) for a, b in
                 zip(learner.params.values(), start))
    bound = 1e-5 * max(1.0, update)
    log(f"  [20b] config #1 from_learner ({n} clients, "
        f"{learner.num_steps} steps): one chunk vs run_round max abs diff "
        f"{diff1:.3e} (bitwise), 4 chunks {diff4:.3e} (bound {bound:.3e}: "
        f"the largest update entry {update:.3e}); s and loss "
        f"{json.dumps(secs)}; {card()}")
    if diff1 != 0.0 or not diff4 <= bound:
        raise AssertionError(f"20b: one chunk {diff1}, 4 chunks {diff4}")
    return secs


def fleet_async_path() -> dict:
    """20c: ``fleetsim --async-buffer auto --async-observe`` and
    ``--async-buffer 8 --aggregators 2`` for 6 aggregations at the
    command's default 10,000 devices through ``cli.main``: each returns
    (exit 0) with ``model_version`` 6.  The process registry is reset
    before each, so each summary's staleness percentiles (read from the
    registry's histogram) are its own run's."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    out = {}
    for label, extra in (("auto", ["--async-buffer", "auto",
                                   "--async-observe"]),
                         ("tree", ["--async-buffer", "8",
                                   "--aggregators", "2"])):
        telemetry.get_registry().reset()
        t0 = time.perf_counter()
        summary, _ = _stderr_of(lambda: cli.main(
            ["fleetsim", "--rounds", str(FLEET_ASYNC_ROUNDS), *extra]))
        keys = ("model_version", "buffer_size", "arrival_tracking",
                "staleness_p90", "agg_fold_tracking_min")
        out[label] = {k: summary.get(k) for k in keys}
        out[label]["s"] = round(time.perf_counter() - t0, 3)
        if summary["model_version"] != FLEET_ASYNC_ROUNDS:
            raise AssertionError(f"20c {label}: {summary}")
    log(f"  [20c] fleetsim async at 10,000 devices, "
        f"{FLEET_ASYNC_ROUNDS} aggregations: {json.dumps(out)}; {card()}")
    return out


def fleet_phase(A, F) -> dict:
    """Phase 20: the fleet simulator on the card (20a the million-device
    command with faults and a trace, 20b the parity with the engine's
    round, 20c the asynchronous plane flat and as a tree).  Returns its
    launches (the MLP runs none of the kernels)."""
    from colearn_federated_learning_tpu_torch.ops import _build

    A.reset_launches()
    F.reset_launches()
    numbers = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        numbers["20a"] = fleet_cli_path(workdir)
        log(f"  20a in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        numbers["20a_observed"] = fleet_observe_path()
        log(f"  20a observed in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    numbers["20b"] = fleet_learner_path()
    log(f"  20b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    numbers["20c"] = fleet_async_path()
    log(f"  20c in {time.perf_counter() - t0:.2f} s")
    launches = {**A.launches, **F.launches}
    if any(launches.values()):
        raise AssertionError(f"20: a kernel launched on the MLP: {launches}")
    log("phase 20 numbers " + json.dumps(numbers))
    return launches


# ------------------------------------------------------------ phase 21
LEARN_ROUNDS = 12           # 21b: the JAX package's scripts/learn_smoke.py
LEARN_SPIKE_ROUND = 9
LEARN_SPIKE_MULTIPLIER = 10.0
LEARN_RULES = ("live-learn-divergence", "live-learn-plateau")  # judged
SENTINEL_AGGS = 30          # 21c's aggregations, at K = 32
REPO = os.path.dirname(os.path.abspath(__file__))


def _stdout_of(fn) -> str:
    """Run ``fn()`` with this process's stdout captured and return the
    text; on an error (a command's non-zero exit too) the text goes to
    stderr before the error propagates."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            fn()
    except BaseException:
        sys.stderr.write(out.getvalue())
        raise
    return out.getvalue()


def _jsonable(obj):
    """numpy scalars and arrays in a record, as the learn smoke writes
    them."""
    if hasattr(obj, "item") and not isinstance(obj, (list, dict)):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj)!r}")


def _sentinel_root(workdir: str, name: str, file: str, recs: list) -> str:
    """A root holding the repo's ``pyproject.toml`` and ``recs`` as
    ``{"event": "round", ...}`` rows in ``results/<file>``."""
    root = os.path.join(workdir, name)
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    shutil.copy(os.path.join(REPO, "pyproject.toml"), root)
    with open(os.path.join(root, "results", file), "w") as f:
        for rec in recs:
            f.write(json.dumps({"event": "round", **rec},
                               default=_jsonable) + "\n")
    return root


def _verdicts(root: str, file_part: str) -> dict:
    """The port's sentinel on the rules that read ``file_part`` files,
    by rule id."""
    from colearn_federated_learning_tpu_torch.analysis import sentinel

    rules = [r for r in sentinel.load_rules(root) if file_part in r.file]
    return {r["id"]: r for r in sentinel.evaluate_slo(root, rules)["results"]}


def lint_path() -> dict:
    """21a: ``lint --gate --format json`` over the port's package."""
    from colearn_federated_learning_tpu_torch import cli

    t0 = time.perf_counter()
    text = _stdout_of(lambda: cli.main(["lint", "--gate", "--format",
                                        "json", "--root", REPO]))
    secs = time.perf_counter() - t0
    doc = json.loads(text)
    log(f"  [21a] lint --gate over the port: {doc['files']} files, "
        f"{len(doc['findings'])} findings, {doc['suppressed']} suppressed, "
        f"{doc['baselined']} baselined in {secs:.3f} s")
    if doc["findings"] or doc["baselined"] or doc["files"] < 100:
        raise AssertionError(f"21a: {doc}")
    return dict(files=doc["files"], suppressed=doc["suppressed"],
                s=round(secs, 3))


def _learn_run(**fed_kw) -> list:
    """One observed 12-round FleetSim run of the learn smoke's
    configuration on the card; its round records."""
    from colearn_federated_learning_tpu_torch import fleetsim
    from colearn_federated_learning_tpu_torch.utils.config import (
        ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    fed = dict(strategy="fedavg", local_steps=2, batch_size=8, lr=0.05,
               momentum=0.0, **fed_kw)
    cfg = ExperimentConfig(
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                          depth=1),
        fed=FedConfig(**fed),
        run=RunConfig(name="learn_smoke", seed=0, learn_observe=True))
    spec = fleetsim.PopulationSpec(num_devices=64, feature_dim=16,
                                   shard_capacity=16, min_examples=4, seed=0)
    traffic = fleetsim.TrafficModel(
        fleetsim.TrafficSpec(base_rate=2000.0, diurnal_amplitude=0.0,
                             seed=0), spec.num_devices)
    sim = fleetsim.FleetSim.from_population(
        cfg, fleetsim.DevicePopulation(spec), traffic, cohort_size=16,
        chunk_size=16)
    if sim.device.type != "cuda":
        raise AssertionError(f"21b: FleetSim on {sim.device}")
    recs = sim.fit(LEARN_ROUNDS)
    if len(recs) != LEARN_ROUNDS or not all(
            "conv_update_norm" in r for r in recs):
        raise AssertionError(f"21b: records {[sorted(r) for r in recs]}")
    return recs


def learn_sentinel_path(workdir: str) -> dict:
    """21b: the learn smoke on the card, judged by the live learning
    sentinels: the clean run ok and judged, the spiked one tripping
    ``live-learn-divergence`` by round 11."""
    clean = _learn_run()
    ok = _verdicts(_sentinel_root(workdir, "learn_clean",
                                  "learn_events.jsonl", clean),
                   "learn_events")
    spiked = _learn_run(lr_spike_round=LEARN_SPIKE_ROUND,
                        lr_spike_multiplier=LEARN_SPIKE_MULTIPLIER)
    red = _verdicts(_sentinel_root(workdir, "learn_spike",
                                   "learn_events.jsonl",
                                   spiked[:LEARN_SPIKE_ROUND + 3]),
                    "learn_events")
    live = sorted(ok)              # the three rules over learn_events
    pre = round(clean[LEARN_SPIKE_ROUND - 1]["conv_update_norm"], 6)
    pre_s = round(spiked[LEARN_SPIKE_ROUND - 1]["conv_update_norm"], 6)
    div = red["live-learn-divergence"]
    summary = {i: {k: ok[i][k] for k in ("ok", "rows", "value", "reason")}
               for i in live}
    log(f"  [21b] learn smoke on the card, clean: {json.dumps(summary)}")
    log(f"  [21b] spiked (x{LEARN_SPIKE_MULTIPLIER:g} at round "
        f"{LEARN_SPIKE_ROUND}): live-learn-divergence ok {div['ok']}, "
        f"value {div['value']}, reason {div['reason']}; round 8 norm "
        f"{pre_s} against the clean run's {pre}; {card()}")
    judged = all(ok[i]["rows"] == LEARN_ROUNDS and ok[i]["value"] is not None
                 for i in LEARN_RULES)
    if not (len(live) == 3 and all(ok[i]["ok"] for i in live) and judged):
        raise AssertionError(f"21b clean: {summary}")
    if div["ok"] or not str(div["reason"]).startswith("above_max_ratio"):
        raise AssertionError(f"21b spiked: {div}")
    if pre != pre_s:
        raise AssertionError(f"21b: round 8 norm {pre_s} against {pre}")
    return dict(clean={i: ok[i]["value"] for i in LEARN_RULES},
                spike_ratio=div["value"])


def async_sentinel_path(workdir: str) -> dict:
    """21c: ``fleetsim --async-buffer 32 --async-observe`` for 30
    aggregations at the command's 10,000 devices, judged by the live
    asynchronous sentinels."""
    from colearn_federated_learning_tpu_torch import cli, telemetry

    telemetry.get_registry().reset()
    t0 = time.perf_counter()
    summary, err = _stderr_of(lambda: cli.main(
        ["fleetsim", "--rounds", str(SENTINEL_AGGS), "--async-buffer",
         "32", "--async-observe"]))
    secs = time.perf_counter() - t0
    recs = [json.loads(line) for line in err.splitlines()
            if line.startswith('{"aggregation"')]
    got = _verdicts(_sentinel_root(workdir, "async", "async_events_port.jsonl",
                                   recs), "async_events")
    tail = got["live-async-staleness-tail-drift"]
    rate = got["live-async-arrival-rate-floor"]
    log(f"  [21c] fleetsim async at 10,000 devices, {len(recs)} "
        f"aggregations in {secs:.2f} s: live-async-staleness-tail-drift "
        f"ok {tail['ok']} rows {tail['rows']} value {tail['value']} "
        f"reason {tail['reason']}; live-async-arrival-rate-floor ok "
        f"{rate['ok']} rows {rate['rows']} reason {rate['reason']} (FleetSim "
        f"writes arrival_rate_per_min, not the coordinator's "
        f"arrival_rate_per_s); {card()}")
    if (summary["model_version"] != SENTINEL_AGGS
            or len(recs) != SENTINEL_AGGS or tail["rows"] < 25
            or not tail["ok"] or tail["value"] is None):
        raise AssertionError(f"21c: {summary}, {tail}")
    return dict(rows=tail["rows"], value=tail["value"], s=round(secs, 3),
                arrival_rate_floor=rate["reason"])


def sentinel_path() -> dict:
    """21d: ``sentinel --root <repo> --format json``: ok, every rule of
    ``pyproject.toml`` (32), no violation."""
    from colearn_federated_learning_tpu_torch import cli

    doc = json.loads(_stdout_of(lambda: cli.main(
        ["sentinel", "--root", REPO, "--format", "json"])))
    log(f"  [21d] sentinel over the repo: ok {doc['ok']}, {doc['rules']} "
        f"rules, {doc['violations']} violations")
    if not doc["ok"] or doc["rules"] != 32 or doc["violations"]:
        raise AssertionError(f"21d: {doc}")
    return dict(rules=doc["rules"])


def analysis_phase(A, F) -> dict:
    """Phase 21: the analysis tools (21a lint, 21b and 21c the live
    sentinels on rows the card wrote, 21d the repo's sentinel).  Returns
    its launches (the MLPs run none of the kernels)."""
    from colearn_federated_learning_tpu_torch.ops import _build

    A.reset_launches()
    F.reset_launches()
    numbers = {"21a": lint_path()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        t0 = time.perf_counter()
        numbers["21b"] = learn_sentinel_path(workdir)
        log(f"  21b in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        numbers["21c"] = async_sentinel_path(workdir)
        log(f"  21c in {time.perf_counter() - t0:.2f} s")
    numbers["21d"] = sentinel_path()
    launches = {**A.launches, **F.launches}
    if any(launches.values()):
        raise AssertionError(f"21: a kernel launched on the MLP: {launches}")
    log("phase 21 numbers " + json.dumps(numbers))
    return launches


# ------------------------------------------------------------ phase 22
# The sentinel's rules phase 22 prints and does not assert: they read
# fleet_round rows at 1,000,000 devices, which the phase does not write
# (the chunk loop trains one client at a time).
UNJUDGED_RULES = ("fleet-1m-round-rate", "fleet-1m-client-throughput")
MILLION = 1_000_000
# 22c's cuts of bench_wire's sweep (its defaults: 5 rounds, cohorts 2 and
# 4, 3 timed folds per fold row, 2 timed saves per checkpoint row), so
# that the script stays under 900 s; every row a rule reads is written.
WIRE_CUTS = ("--rounds", "2", "--cohorts", "4", "--fold-repeats", "1",
             "--ckpt-repeats", "1")


def _port_script(name: str):
    """``scripts/torch_port_<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(REPO, "scripts", f"torch_port_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_port_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _run_script(tag: str, name: str, argv: list) -> float:
    """``main(argv)`` of a driver, its printed rows captured; fails on a
    non-zero exit.  Returns its seconds."""
    mod = _port_script(name)
    t0 = time.perf_counter()
    text = _stdout_of(lambda: _check_rc(tag, mod.main(argv)))
    secs = time.perf_counter() - t0
    log(f"  [{tag}] {name} {' '.join(argv[:-2])}: {len(text.splitlines())} "
        f"lines in {secs:.2f} s")
    return secs


def _check_rc(tag: str, rc) -> None:
    if rc not in (0, None):
        raise AssertionError(f"{tag}: exit code {rc}")


def north_star_path(results: str) -> dict:
    """22a: ``perf_north_star`` at its full shape, 3 timed rounds."""
    out = os.path.join(results, "perf_north_star.jsonl")
    secs = _run_script("22a", "perf_north_star",
                       ["--rounds", "3", "--warmup", "1", "--out", out])
    meta, *rounds, summary = _rows(out)
    log(f"  [22a] north star: {summary['rounds_per_sec']} rounds/sec, "
        f"{summary['client_samples_per_sec_per_chip']} client-samples/sec, "
        f"peak {meta['hbm_peak_per_chip_gb']} GiB, flops_per_round "
        f"{summary['flops_per_round']:.6e}, model_flops_utilization "
        f"{summary['model_flops_utilization']}; summary "
        f"{json.dumps(summary)}; {card()}")
    if not (summary["platform"] == "gpu" and len(rounds) == 3
            and summary["rounds_per_sec"] > 0
            and summary["cohort"] == 64 and summary["local_steps"] == 8
            and summary["flops_per_round"] > 0
            and summary["model_flops_utilization"] is not None
            and 0 < summary["model_flops_utilization"] < 1):
        raise AssertionError(f"22a: {meta}, {summary}")
    return dict(s=round(secs, 2), rounds_per_sec=summary["rounds_per_sec"],
                mfu=summary["model_flops_utilization"])


def fleet_bench_path(results: str) -> dict:
    """22b: ``bench_fleet --cohorts 1000`` and every sweep at its
    defaults."""
    out = os.path.join(results, "fleet_bench.jsonl")
    secs = _run_script("22b", "bench_fleet", [
        "--cohorts", "1000", "--mask-sweep", "--uplink-sweep",
        "--ingest-sweep", "--async-sweep", "--tree-async-sweep",
        "--drift-sweep", "--check-schema", "--out", out])
    rows = _rows(out)
    kinds = {}
    for r in rows:
        kinds[r["bench"]] = kinds.get(r["bench"], 0) + 1
    point = next(r for r in rows if r["bench"] == "fleet_round")
    walls = {r["bench"]: r["bench_wall_s"] for r in rows
             if r["bench"] in ("fleet_round", "fleet_async_prune",
                               "fleet_async_autok", "fleet_learn_drift")}
    walls["fleet_tree_async"] = next(
        r["bench_wall_s"] for r in rows if r["bench"] == "fleet_tree_async"
        and r["mode"] == "measured")
    log(f"  [22b] {len(rows)} rows {json.dumps(kinds)}; seconds per "
        f"measured point {json.dumps(walls)}; cohort 1,000: "
        f"{point['clients_per_sec']} clients/s, "
        f"{point['round_time_s_mean']} s per round, so "
        f"{MILLION / point['clients_per_sec']:.1f} s per round at a cohort "
        f"of 1,000,000 (the rules' floor: 10,000 clients/s); {card()}")
    want = {"fleet_round": 1, "fleet_mask_cost": 5, "fleet_uplink_bytes": 3,
            "fleet_ingest_scaling": 3, "fleet_async": 4,
            "fleet_async_prune": 1, "fleet_async_autok": 1,
            "fleet_tree_async": 4, "fleet_learn_drift": 1}
    if kinds != want or point["clients_trained"] != 2000:
        raise AssertionError(f"22b: {kinds}, {point}")
    return dict(s=round(secs, 2), clients_per_sec=point["clients_per_sec"])


def wire_bench_path(F, results: str) -> dict:
    """22c: ``bench_wire`` at its defaults, then ``--fold-device``
    rounds; both sets of rows in ``wire_bench.jsonl``."""
    out = os.path.join(results, "wire_bench.jsonl")
    fold_out = os.path.join(results, "wire_fold_device.jsonl")
    secs = _run_script("22c", "bench_wire", [*WIRE_CUTS, "--check-schema",
                                             "--out", out])
    launches = dict(F.launches)
    secs += _run_script("22c", "bench_wire", [
        "--fold-device", "--cohorts", "4", "--down-schemes", "none",
        "--tp-sizes", "1", "--schemes", "topk8", "--feedback", "off",
        "--lora-ranks", "", "--fold-frames", "", "--ckpt-tp", "0",
        "--check-schema", "--out", fold_out])
    rows, fold_rounds = _rows(out), _rows(fold_out)
    with open(out, "a") as f:
        for r in fold_rounds:
            f.write(json.dumps(r) + "\n")
    folds = [r for r in rows if r["bench"] == "wire_fold"]
    walls: dict = {}
    for r in rows:
        if r["bench"] in ("wire_round", "wire_lora"):
            walls[r["bench"]] = walls.get(r["bench"], 0.0) + r["bench_wall_s"]
        else:                       # cumulative within a frame or the pair
            key = f"{r['bench']}/{r.get('frame', '')}"
            walls[key] = max(walls.get(key, 0.0), r["bench_wall_s"])
    log(f"  [22c] seconds by kind {json.dumps(walls)}")
    for r in folds:
        log(f"  [22c] wire_fold {r['frame']} {r['path']} batch {r['batch']}: "
            f"{r['updates_per_s']} updates/s, {r['speedup_vs_host']}x the "
            f"host, parity {r['parity_bitwise']}, {r['kernel_backend']}")
    for r in (r for r in rows if r["bench"] == "wire_ckpt"):
        log(f"  [22c] wire_ckpt {r['path']}: save {r['save_s']} s, restore "
            f"{r['restore_s']} s, gather_avoided {r['gather_avoided']}, "
            f"bitwise {r['restore_bitwise']}")
    log(f"  [22c] --fold-device rounds: "
        + "; ".join(f"{r['scheme_up']} up {r['fold_device_folds_per_round']}"
                    f" folds per round of {r['cohort']}, "
                    f"{r['round_time_s_mean']} s" for r in fold_rounds)
        + f"; launches {json.dumps(dict(F.launches))}; {card()}")
    device = [r for r in folds if r["path"] == "device"]
    if len(device) != 6 or not all(r["parity_bitwise"] and
                                   r["kernel_backend"] == "cuda"
                                   for r in device):
        raise AssertionError(f"22c: device fold rows {device}")
    if len(fold_rounds) != 2 or any(
            r["fold_device_folds_per_round"] != r["cohort"]
            for r in fold_rounds):
        raise AssertionError(f"22c: --fold-device rows {fold_rounds}")
    if not (launches["fold_sparse"] and launches["fold_dense"]
            and F.launches["fold_sparse"] > launches["fold_sparse"]
            and F.launches["fold_dense"] > launches["fold_dense"]):
        raise AssertionError(f"22c: launches {launches}, {F.launches}")
    return dict(s=round(secs, 2), updates_per_s={
        f"{r['frame']}/{r['path']}/{r['batch']}": r["updates_per_s"]
        for r in folds})


def mesh_smoke_path(results: str) -> dict:
    """22d: ``mesh_smoke`` at its defaults."""
    out = os.path.join(results, "mesh_bench.jsonl")
    secs = _run_script("22d", "mesh_smoke", ["--out", out])
    compare = _rows(out)[-1]
    log(f"  [22d] mesh smoke: {json.dumps(compare)}")
    if not (compare["fold_bitwise_ok"] and compare["frame_bytes_ok"]):
        raise AssertionError(f"22d: {compare}")
    return dict(s=round(secs, 2),
                ratio=compare["hbm_ratio_sharded_over_replicated"])


def measured_sentinel_path(root: str) -> dict:
    """22e: the port's sentinel over the rows 22a-22d wrote."""
    from colearn_federated_learning_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(["sentinel", "--root", root, "--format", "json"])
        except SystemExit as e:       # 1: the unjudged rules' violations
            if e.code not in (0, 1, None):
                raise
    doc = json.loads(out.getvalue())
    for r in doc["results"]:
        log(f"  [22e] {r['id']}: value {r['value']}, rows {r['rows']}, "
            f"ok {r['ok']}, reason {r['reason']}"
            + (" (printed, not asserted)" if r["id"] in UNJUDGED_RULES
               else ""))
    bad = [r for r in doc["results"]
           if not r["ok"] and r["id"] not in UNJUDGED_RULES]
    judged = [r for r in doc["results"] if r["rows"] > 0]
    if doc["rules"] != 32 or bad:
        raise AssertionError(f"22e: {bad}")
    return dict(rules=doc["rules"], judged_on_rows=len(judged),
                violations=doc["violations"])


def measure_phase(A, F) -> dict:
    """Phase 22: the measurement drivers on the card and the sentinel over
    their rows.  Returns its launches (22c's folds)."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.ops import _build

    A.reset_launches()
    F.reset_launches()
    telemetry.get_registry().reset()
    numbers = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        results = os.path.join(root, "results")
        os.makedirs(results)
        shutil.copy(os.path.join(REPO, "pyproject.toml"), root)
        numbers["22a"] = north_star_path(results)
        numbers["22b"] = fleet_bench_path(results)
        numbers["22c"] = wire_bench_path(F, results)
        numbers["22d"] = mesh_smoke_path(results)
        numbers["22e"] = measured_sentinel_path(root)
    launches = {**A.launches, **F.launches}
    if any(A.launches.values()):
        raise AssertionError(f"22: attention kernels launched: {launches}")
    log("phase 22 numbers " + json.dumps(numbers))
    return launches


# ------------------------------------------------------------ phase 23
# 23c: the curves run to their rounds; every other variant runs 1 round.
CURVES = ("mnist_mlp_fedavg", "agnews_bert_fedavg", "iot_traffic_tcn_fedavg")
# 23c's process groups beside the agnews curve (which runs in this
# process, so that its K1-K3 launches are counted): each group is one
# process of run_baseline_configs, a group's processes one after another.
VARIANT_GROUPS = (
    (("mnist_mlp_fedavg,iot_traffic_tcn_fedavg",),),
    (("cifar10_cnn_fedavg,cifar100_resnet18_fedprox,agnews_moebert_fedavg,"
      "femnist_vit_cross_silo", "--rounds", "1"),),
    (("agnews_bert_full,femnist_vit3400_scaled", "--rounds", "1"),),
    # femnist_vit_full3400's cohort 256 (about 1,024 ViT-B/16 steps) cut.
    (("femnist_vit_full3400", "--rounds", "1", "--cohort", "64"),),
)
# 23f's four phases as two processes of the smoke (its argv selection).
OBS_GROUPS = (("classic", "tree"), ("async", "learning"))
MIN_FINAL_ACC = 0.95            # mnist's and the TCN's last accuracy
RISE_SHARE = 0.5                # of the JAX curve's rise, round 0 -> 19
# 23b's timed rounds and warm-up (the bench's default 20 and 2, and its
# baseline, are 9c's).
TORCHRUN_ROUNDS, TORCHRUN_WARMUP = 5, 1


def _python_env() -> dict:
    return dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def entry_path(A, root: str) -> dict:
    """23a: the flagship forward through K1 against the dense core on the
    same parameters; the dry run in-process at world 1 and through its
    recorder."""
    import torch.distributed as dist

    from colearn_federated_learning_tpu_torch import dryrun
    from colearn_federated_learning_tpu_torch.models import registry
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    fn, (params, x) = dryrun.entry()
    cfg = get_config(dryrun.FLAGSHIP).model
    g = torch.Generator(device="cuda").manual_seed(23)
    inputs = {"zeros": x, "seeded": torch.randn(x.shape, generator=g,
                                                device="cuda")}
    A.reset_launches()
    got = {k: fn(params, v) for k, v in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(A.launches)
    want = {"flash_forward": 2 * cfg.depth, "flash_backward_dq": 0,
            "flash_backward_dkv": 0}
    if launches != want:
        raise AssertionError(f"23a: launches {launches}, want {want}")
    errs = {}
    plain = [registry.build_model(
        dataclasses.replace(cfg, attn_impl="dense", dtype=dt), "cuda",
        input_shape=dryrun.ENTRY_BATCH[1:]).eval()
        for dt in (cfg.dtype, "float32")]
    for k, v in inputs.items():
        with torch.no_grad():
            ref, truth = (torch.func.functional_call(m, params, (v,))
                          for m in plain)
        if tuple(got[k].shape) != (8, cfg.num_classes):
            raise AssertionError(f"23a: logits {tuple(got[k].shape)}")
        errs[k] = check_close(f"23a entry {k}", got[k], ref, truth)
    del plain
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            run = dryrun.dryrun_multichip(1)
            dry_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    if [r["mesh"] for r in run["runs"]] != [{"clients": 1}]:
        raise AssertionError(f"23a: dry run {run}")
    log(f"  [23a] entry logits max abs err vs the plain core "
        f"{json.dumps(errs)}, K1 launches {launches['flash_forward']}; "
        f"dry run at world 1 {json.dumps(run['runs'])} in {dry_s:.2f} s; "
        f"{card()}")
    return dict(entry_err=errs, dryrun_s=round(dry_s, 2))


def record_dryrun_path(root: str) -> dict:
    """23a's record: ``torch_port_record_dryrun.py 1`` as a process (run
    beside 23c)."""
    out = os.path.join(root, "dryrun_multichip.json")
    _, _, secs = script_process("23a", ["record_dryrun", "1", "--out", out],
                                300)
    with open(out) as f:
        rec = json.load(f)
    log(f"  [23a] record_dryrun 1: {json.dumps(rec)}; {secs:.2f} s")
    if not (rec["platform"].startswith("gpu") and rec["runs"][0]["ok"]):
        raise AssertionError(f"23a: record {rec}")
    return dict(s=round(secs, 2))


def bench_torchrun_path(bench9c: dict) -> dict:
    """23b: ``cli bench --rounds 5 --warmup 1 --skip-baseline`` under
    ``torchrun --nproc-per-node 1`` (9c runs 20 rounds after 2 and the
    reference-style baseline)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m",
            "colearn_federated_learning_tpu_torch.cli", "bench",
            "--rounds", str(TORCHRUN_ROUNDS), "--warmup",
            str(TORCHRUN_WARMUP), "--skip-baseline"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                       env=_python_env(), timeout=600)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise AssertionError(f"23b: torchrun bench exited {r.returncode}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"  [23b] torchrun bench: {out['value']} rounds/sec (9c in-process "
        f"{bench9c['value']}), n_devices {out['n_devices']}, "
        f"{out['client_samples_per_sec_per_chip']} client-samples/sec/chip, "
        f"vs_baseline {out['vs_baseline']}, {secs:.2f} s; {out.get('card')}")
    if not (out["n_devices"] == 1 and out["platform"] == "gpu"
            and out["value"] > 0):
        raise AssertionError(f"23b: {out}")
    return dict(rounds_per_sec=out["value"], s=round(secs, 2))


def _curve(rows) -> list:
    return [round(r["eval_acc"], 4) for r in rows if "eval_acc" in r]


def variant_group(results: str, group: tuple) -> float:
    """One of 23c's process groups; returns its seconds."""
    secs = 0.0
    for only, *extra in group:
        _, _, s = script_process("23c", [
            "run_baseline_configs", "--only", only, "--attn-impl", "flash",
            "--out", results, *extra], 900)
        log(f"  [23c] run_baseline_configs --only {only} "
            f"{' '.join(extra)}: {s:.2f} s (a process)")
        secs += s
    return secs


def baseline_path(A, root: str) -> dict:
    """23c: the baseline variants through K1-K3 (see the module
    docstring): the agnews curve in this process, the other variants in
    VARIANT_GROUPS's processes beside it.  Returns the groups' threads
    (joined by :func:`check_baselines`) and the curve's seconds."""
    results = os.path.join(root, "baseline")
    groups = [Beside(f"23c group {i}", variant_group, results, g)
              for i, g in enumerate(VARIANT_GROUPS)]
    A.reset_launches()
    secs = _run_script("23c", "run_baseline_configs", [
        "--only", "agnews_bert_fedavg", "--attn-impl", "flash", "--out",
        results])
    return groups, dict(A.launches), round(secs, 2)


def check_baselines(root: str, groups, launches: dict, agnews_s) -> dict:
    """23c's checks over every variant's records, once its processes are
    joined."""
    mod = _port_script("run_baseline_configs")
    results = os.path.join(root, "baseline")
    secs = {"agnews_bert_fedavg": agnews_s}
    for i, g in enumerate(groups):
        secs[f"group {i}"] = round(g.join(), 2)
    curves = {}
    for name in mod.scaled_variants():
        meta, *rows = _rows(os.path.join(results, f"{name}.jsonl"))
        losses = [r[k] for r in rows for k in ("train_loss", "eval_loss")
                  if k in r]
        if not (rows and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"23c: {name} losses {losses}")
        curves[name] = _curve(rows)
        log(f"  [23c] {name}: {meta['note']}; {len(rows)} rounds, cohort "
            f"{meta['cohort']}, {meta['local_steps']} steps; eval_acc "
            f"{curves[name]}; last train_loss {rows[-1]['train_loss']}")
    jax_curve = _curve(_rows(os.path.join(REPO, "results",
                                          "agnews_bert_fedavg.jsonl"))[1:])
    ours = curves["agnews_bert_fedavg"]
    rise, jax_rise = ours[-1] - ours[0], jax_curve[-1] - jax_curve[0]
    log(f"  [23c] agnews_bert_fedavg rise {rise:.4f} (port {ours[0]} -> "
        f"{ours[-1]}) against the JAX package's {jax_rise:.4f} "
        f"({jax_curve[0]} -> {jax_curve[-1]}); JAX curve {jax_curve}; "
        f"launches {json.dumps(launches)}; {card()}")
    if len(ours) != 20 or rise < RISE_SHARE * jax_rise:
        raise AssertionError(f"23c: agnews curve {ours}")
    for name in ("mnist_mlp_fedavg", "iot_traffic_tcn_fedavg"):
        if curves[name][-1] < MIN_FINAL_ACC:
            raise AssertionError(f"23c: {name} curve {curves[name]}")
    if not all(launches.values()):
        raise AssertionError(f"23c: launches {launches}")
    return dict(s=secs, rise=round(rise, 4), jax_rise=round(jax_rise, 4),
                launches=launches)


def script_process(tag: str, argv: list, timeout: float) -> tuple:
    """``scripts/torch_port_<argv[0]>.py argv[1:]`` as a process on the
    card; fails on a non-zero exit.  Returns (stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      f"torch_port_{argv[0]}.py"),
         *argv[1:]], capture_output=True, text=True, cwd=REPO,
        env=_python_env(), timeout=timeout)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-6000:])
        raise AssertionError(f"{tag}: {argv[0]} exited {r.returncode}")
    return r.stdout, r.stderr, secs


def proc_soak_path() -> dict:
    """23e: the process soak's gate, as a process on the card."""
    out, _, secs = script_process("23e", ["chaos_soak_mp"], 900)
    doc = json.loads(out.strip().splitlines()[-1])
    f = doc["faulted"]
    log(f"  [23e] chaos_soak_mp: problems {doc['problems']}; faulted "
        f"rounds_run {f['rounds_run']}, rounds_resumed {f['rounds_resumed']}"
        f", kills {[k.get('target') for k in f['kills']]}, acc baseline "
        f"{doc['baseline']['weighted_acc']} faulted {f['weighted_acc']}; "
        f"{secs:.2f} s")
    return dict(s=round(secs, 2), kills=len(f["kills"]))


def obs_smoke_path(phases: tuple) -> dict:
    """23f: phases of the observability smoke, as a process (its fleets
    on the card)."""
    _, err, secs = script_process("23f", ["obs_smoke", *phases], 900)
    checks = [ln for ln in err.splitlines() if ln.startswith("[obs-smoke]")]
    ok = sum(ln.startswith("[obs-smoke] ok:") for ln in checks)
    failed = [ln for ln in checks if ln.startswith("[obs-smoke] FAIL:")]
    log(f"  [23f] obs_smoke {' '.join(phases)}: {ok} checks ok, "
        f"{len(failed)} failed, over "
        f"{sum('phase:' in ln for ln in checks)} phases in {secs:.2f} s")
    if failed or not ok or "all checks passed" not in checks[-1]:
        raise AssertionError(f"23f: {checks}")
    return dict(s=round(secs, 2), checks=ok)


def soak_path() -> dict:
    """23d: the in-process soak's gate, as a process on the card."""
    out, _, secs = script_process("23d", ["chaos_soak"], 600)
    doc = json.loads(out.strip().splitlines()[-1])
    f = doc["faulted"]
    log(f"  [23d] chaos_soak: problems {doc['problems']}, skipped "
        f"{f['skipped_rounds']}, evicted {f['evicted']}, acc baseline "
        f"{doc['baseline']['weighted_acc']} faulted {f['weighted_acc']}, "
        f"{secs:.2f} s")
    return dict(s=round(secs, 2))


def trace_path(root: str) -> dict:
    """23d: the trace smoke on the card, alone (its coverage is a share
    of 25 ms rounds)."""
    t0 = time.perf_counter()
    res = _port_script("trace_smoke").main(os.path.join(root, "trace"))
    secs = time.perf_counter() - t0
    log(f"  [23d] trace smoke: {res['spans']} spans, phases "
        f"{res['phases']}, coverage {res['coverage']:.4f}, {secs:.2f} s")
    if not (res["coverage"] >= 0.95 and res["device"].startswith("cuda")):
        raise AssertionError(f"23d: trace smoke {res}")
    return dict(coverage=round(res["coverage"], 4), s=round(secs, 2))


def drivers_phase(A, bench9c: dict) -> dict:
    """Phase 23: the last drivers (see the module docstring).  Returns
    23c's launches."""
    from colearn_federated_learning_tpu_torch.ops import _build

    numbers = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        numbers["23a"] = entry_path(A, root)
        numbers["23b"] = bench_torchrun_path(bench9c)
        beside = {"23a record": Beside("23a record", record_dryrun_path,
                                       root),
                  "23e": Beside("23e", proc_soak_path),
                  "23d soak": Beside("23d soak", soak_path),
                  **{f"23f {' '.join(g)}": Beside("23f", obs_smoke_path, g)
                     for g in OBS_GROUPS}}
        groups, launches, agnews_s = baseline_path(A, root)
        numbers["23c"] = check_baselines(root, groups, launches, agnews_s)
        for tag, b in beside.items():
            numbers[tag] = b.join()
        numbers["23d"] = trace_path(root)
    log("phase 23 numbers " + json.dumps(numbers))
    return numbers["23c"]["launches"]


def cache_synthetic_data():
    """Draw each synthetic dataset once in this process: every later draw
    of the same (dataset, seed) gets a copy of the first one's arrays
    (equal to a fresh draw; a copy, so that no path sees another's edits).
    The engines, coordinators and silos of the paths draw CIFAR-10 about
    ten times, each a 614 MB draw of several seconds on the host."""
    from colearn_federated_learning_tpu_torch.data import registry

    made = {}
    draw = registry._make_synthetic

    def cached(spec, seed):
        if (spec.name, seed) not in made:
            made[spec.name, seed] = draw(spec, seed)
        ds = made[spec.name, seed]
        return dataclasses.replace(
            ds, x_train=ds.x_train.copy(), y_train=ds.y_train.copy(),
            x_test=ds.x_test.copy(), y_test=ds.y_test.copy())

    registry._make_synthetic = cached


def build_phase(_build):
    """Build the kernels; report each head-dim-64 instantiation's registers,
    spills and blocks per SM, and fail if any instantiation spills."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    props = {}                     # mangled name -> ptxas lines
    for text in logs.values():
        func = ""
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
            elif func and ("spill stores" in line or "Used" in line):
                props.setdefault(func, []).append(
                    line.split(":", 1)[-1].strip())
    spills = [f for f, lines in props.items()
              if re.search(r"[1-9]\d* bytes spill stores", " ".join(lines))]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    if not props:
        raise AssertionError("no ptxas report for the kernels")
    lib = _build.load("flash_attention")
    lib.fa_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.fa_blocks_per_sm.restype = ctypes.c_int
    for kind, name in enumerate(("fwd", "dq", "dkv")):
        blocks = ctypes.c_int(0)
        err = lib.fa_blocks_per_sm(kind, 64, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: cudaError {err}")
        func = next((f for f in props if f"flash_{name}_" in f
                     and "Li64E" in f), None)
        log(f"  {name} D=64: {blocks.value} blocks/SM; "
            + ("; ".join(props[func]) if func else "no ptxas report"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from colearn_federated_learning_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    CKPT["root"] = tempfile.mkdtemp(dir=_build.BUILD_DIR, prefix="ckpt-")
    CKPT["chaos"] = ckpt_dir("chaos")
    CKPT["chaos_tree"] = ckpt_dir("chaos_tree")
    CKPT["chaos_ckpt"] = ckpt_dir("chaos_ckpt")
    try:
        return run_phases()
    finally:
        for fleet in FLEETS.values():
            fleet.kill()
        shutil.rmtree(CKPT["root"], ignore_errors=True)


PHASE_S: dict = {}          # phase -> wall seconds


def phase(n, title: str, fn, *args):
    """Run phase ``n`` and print its wall seconds on a line of its own."""
    log(f"phase {n}: {title}")
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[n] = round(time.perf_counter() - t0, 2)
    log(f"  phase {n} in {PHASE_S[n]:.2f} s")
    return out


class Beside:
    """``fn(*args)`` on a thread beside the caller's own work, for work
    whose card use is small beside another's waiting on its processes
    (18c's soak beside 18a's folds and 18b, phase 19 beside 17a and 17b).
    :meth:`join` waits and returns its result or raises its error; ``s``
    is its wall seconds."""

    def __init__(self, name: str, fn, *args):
        self.out, self.error, self.s = None, None, None

        def run():
            t0 = time.perf_counter()
            try:
                self.out = fn(*args)
            except BaseException as e:         # re-raised by join()
                self.error = e
            self.s = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, name=name)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.out


def device_phase() -> None:
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def fold_and_file_phase(A, F):
    """Phase 9: 9a the fold kernel, 9b the file plane, 9c the bench."""
    from colearn_federated_learning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    rows = fold_check_phase(F)
    log(f"  9a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    # The global models and update files (~1.1 GB) go to a temporary
    # directory inside the gitignored build directory, removed afterwards.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        paths = {"file_plane": file_plane_path(A, F, workdir)}
    log(f"  9b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bench = bench_path()
    log(f"  9c in {time.perf_counter() - t0:.2f} s")
    return rows, paths, bench


def run_phases() -> int:
    """Phases 1-23 and the two result lines (see the module docstring)."""
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import attention as A
    from colearn_federated_learning_tpu_torch.ops import fold as F
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    t_start = time.perf_counter()
    cache_synthetic_data()
    register_half_bert()
    phase(1, "device", device_phase)
    phase(2, "build", build_phase, _build)
    rows = phase(3, "kernels vs plain versions (bf16)", kernel_phase, A)

    paths = {}

    def bert():
        small_model_check()
        paths["bert"] = main_path(A)

    def families():
        for label, cfg, cuts in family_paths():
            paths[label] = drive_path(A, label, cfg, 1, cuts,
                                      detection=label == "tcn")

    phase(4, "small-input check and the BERT path", bert)
    paths["cnn"] = phase(5, "the CIFAR-10 CNN round (config #2)", drive_path,
                         A, "cnn", get_config("cifar10_cnn_fedavg"), 2,
                         "none")
    phase(6, "one round of each other family at full width", families)
    paths.update(phase(7, "the round's other branches through the command "
                          "line", cli_phase, A))
    paths.update(phase(8, "hierarchical, clustered and per-client "
                          "evaluation", slice_phase, A))
    fold_rows, file_paths, bench = phase(
        9, "the fold kernel, the file plane and the bench",
        fold_and_file_phase, A, F)
    rows.update(fold_rows)
    paths.update(file_paths)
    paths.update(phase(10, "remat, the client mesh at world 1, "
                           "single-device SP/TP", parallel_phase, A))
    paths.update(phase(11, "the synchronous socket plane", socket_phase, A,
                       F, _build))
    paths.update(phase(12, "the aggregator tree and per-type federation",
                       tree_phase, A, F))
    paths.update(phase(13, "the telemetry core (traces, counters, health "
                           "ledgers)", telemetry_phase, A, F, _build))
    paths.update(phase(14, "the asynchronous coordinator (flat, the tree, "
                           "processes)", async_phase, A, F, _build))
    paths.update(phase(15, "LoRA adapter federation (flat, the tree, "
                           "secure, processes)", lora_phase, A, F))
    paths.update(phase(16, "checkpoints and resume (the engine, a "
                           "SIGKILLed coordinator, streaming restores)",
                       resume_phase, A, F))
    # Phase 19's card work is small beside 17a's soak, whose processes the
    # script waits on: it runs on a thread beside 17a and 17b and is
    # joined before 17c, so 17c's recoveries are read with nothing beside.
    log("phase 19: checkpoints of a learner on a client mesh (on a thread "
        "beside 17a and 17b)")
    mesh = Beside("phase 19", mesh_resume_phase, A, F)

    def join_mesh():
        paths["mesh_resume"] = mesh.join()
        PHASE_S[19] = round(mesh.s, 2)
        log(f"  phase 19 in {PHASE_S[19]:.2f} s (beside 17a and 17b)")

    phase(17, "the chaos soaks (chaos --mp with SIGKILLs, postmortem, "
              "chaos --tree-async under the lock witness)", chaos_phase,
          join_mesh)
    shard_paths, _ = phase(18, "the sharded server (the placed fold, step "
                               "and downlink, the fallbacks, chaos --ckpt)",
                           sharded_phase, F)
    paths.update(shard_paths)
    paths["fleetsim"] = phase(20, "the fleet simulator (a million devices, "
                                  "the engine's round, the asynchronous "
                                  "plane)", fleet_phase, A, F)
    paths["analysis"] = phase(21, "the analysis tools (lint, the live "
                                  "sentinels on the card's rows, sentinel)",
                              analysis_phase, A, F)
    paths["measure"] = phase(22, "the measurement drivers (north star, "
                                 "fleet, wire, mesh) and the sentinel over "
                                 "their rows", measure_phase, A, F)
    paths["drivers"] = phase(23, "the last drivers (the dry run, the bench "
                                 "under torchrun, the baseline curves, the "
                                 "trace smoke, the soak gates, the "
                                 "observability smoke)", drivers_phase, A,
                             bench)
    log("launches per path " + json.dumps(paths))
    total = time.perf_counter() - t_start
    log(f"script {total:.2f} s; phase seconds {json.dumps(PHASE_S)}; 9c "
        f"{bench['value']} rounds/sec; {card()}")

    sources = {**{name: (SOURCE, rep) for name, (rep, _) in KERNELS.items()},
               **{name: (FOLD_SOURCE, rep)
                  for name, rep in FOLD_KERNELS.items()}}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(p.get(name, 0) for p in paths.values()),
                    status="ok", **rows[name])
               for name, (src, rep) in sources.items()]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
