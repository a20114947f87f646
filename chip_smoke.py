#!/usr/bin/env python3
"""Drive the PyTorch port (fenix_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py               # one card or several; ~20 minutes at most

Phases, each printing one JSON line with its own timings:

1. device and build: the card's name and power limit; build the CUDA
   kernel library from fenix_tpu_torch/csrc/ into build/fenix_tpu_torch/.
2. kernel vs plain, on the card: the phase-1 kernels against their plain
   PyTorch version, (a) on 1,048,576 x 128 inputs over Q in {1, 8, 100,
   1024}, bucket in {128, 32} and f32/bf16/int8, then the edge shapes
   (every Q in EDGE_Q x D in EDGE_D x bucket in EDGE_BUCKETS, N not a
   multiple of the 128-row tile where the bucket allows, whole -inf
   buckets; f32 through both the stream and the tiled kernel, int8 at
   EDGE_Q_INT8 through both int8 designs, tensor_int8 where D is a
   multiple of 16, bf16 at EDGE_Q_INT8 through generic_bf16 and, where D
   is a multiple of 8, tensor_bf16), (b) at the exact inputs the main path
   gives it in phase 3 and the glove100 path, each f32/bf16 design forced
   at 8,388,608 rows at the query counts and widths of FORCED and each
   int8 design at FORCED_INT8's shapes over FORCED_INT8_Q, the timings that
   set the dispatcher's rules (kernels.STREAM_MAX_Q, kernels.kernel_for).
   Every timed row also
   carries its bound (the larger of bytes over the read rate and
   operations over the peak rate of their type, see `bound`), its share of
   that bound, and library_ms, one PyTorch call for the product alone
   (`library_fn`); an int8 row is also held bit-equal to the other int8
   design at its inputs (`design_diff`), as every edge shape is.
   Tolerances, per query j:
   f32 and bf16 (both sides widen the same inputs to f32):
   1e-5 * |q_j| * max_i |v_i| * aux_mul_i + 1e-6 * max_i |aux_add_i|;
   int8 (exact integer dot; FMA vs separate rounding in the epilogue):
   2e-6 * (127 * |q8_j|_1 * max_i aux_mul_i + max_i |aux_add_i| * inv_sq_j);
   -inf exactly where the plain version has -inf, no NaN.
3. the main path: a fenix_tpu_torch.launch server in a subprocess takes an
   8,388,608 x 128 fp32 table (int64 id, int32 tag; rows 4096..8191 copy
   rows 0..4095) over Flight in batches of 65,536 rows and answers five
   searches: one flat cosine query (maxval 10), Q=8 cosine top-10,
   Q=1024 l2 top-100 with tag < 50, Q=64 bf16 top-10, Q=256 int8 top-10.
   The server process starts with every kernel launch count at 0; its
   stats action reports them, and each search must raise its route's.
   Then the exact narrow path, "glove100" in the kernels line: on the same
   server a 1,183,514 x 100 table (ann-benchmarks' glove-100-angular shape,
   random normal rows), int8 cosine Q=8 k=10 and Q=1024 k=100 with
   tag < 50, bf16 cosine Q=64 k=10 and Q=1024 k=100: rows TMA cannot
   address, served by generic_int8 and generic_bf16; the path's launches
   are the counts after it less those before.
4. oracle: float64 exact ranking on the card, ordered by (distance, id),
   written independently of the port. fp32 ids must match it position by
   position, exact float64 ties (the duplicate rows) in id order; the
   only swaps allowed are between rows whose float64 distances differ by
   less than NEAR_TIE * max(1, d), which no fp32 engine can order.
   bf16/int8 recall@k >= 0.99; every returned distance within
   1e-4 * max(1, d) of float64. The glove100 searches are held to the
   fp32 rule whatever their scan precision, distances within
   1e-5 * max(1, d) (phase 2 rescores fp32-true), and then the kernel
   against its plain version at each of their phase-1 inputs (the
   engine's rows padded to whole 16,384-row blocks: 1,196,032). A query may return fewer than k rows
   where a filter (and probes) leave fewer; its count must then be
   min(k, the rows the oracle allows), wherever results meet the oracle.
   (c) at 1,048,576 x 768: f32 Q=8 bucket 128, int8 Q=8 bucket 128 and
   Q=1024 bucket 32.
5. warm per-search latency (client wall clock, median of 5).
6. host-corpus residency: a 4,194,304 x 768 fp32 table (BASELINE config
   2's widths, cut from 10M rows; duplicate rows as in phase 3; drawn on a
   host thread from phase 1 on, under the build and phases 2-5) goes over
   Flight to a second server started with FENIX_HBM_BUDGET = 6 GiB, where
   dual residency does not fit and the int8 copy does. First the kernel
   against its plain version at the inputs each search gives it, then
   five l2 top-100 searches with tag < 50: Q=8 auto (must route to int8
   residency), Q=1024 forced int8, Q=8 fp32 stream (10 chunks, one f32
   launch each), Q=64 int8 stream (3 chunks, one int8 launch each), and
   Q=8 forced dual, the same server's exact answer. Each call must move
   its launch count and residency counter by exactly the expected amount;
   after the fourth search no fp32 device matrix may exist and
   cache.device_bytes must be within the budget. The fp32 stream ids must
   equal the dual ids; against the float64 oracle the fp32 routes follow
   phase 4's rule and the int8 routes reach recall@100 >= 0.99. Printed:
   the cold first call (mirror quantize, sidecar write, upload), warm
   latency (median of RES_WARM_REPS = 2) and a warm split from the server's counters
   (device phase A, host gather + rescore, upload GB/s).

7. IVF on the phase-3 server and table: make_index over Flight trains a
   1 x 16,384-cell l2 coder on the card (batch 65,536, 2 epochs: 256
   Lloyd steps) and assigns every row; the server's make-coder and
   make-index seconds and the cell occupancy are printed. Four probed
   searches, k=10, l2 from the coder: Q=1 with 16 probes and Q=8 with 64
   probes and tag < 50 on the clustered gather route, Q=1024 with 64
   probes and Q=256 int8 with 64 probes on the masked-scan route, each
   route asserted through the server's search.ivf_* counters; one cold
   and five warm calls each, the server's split from its counters. Then,
   with the server gone: 1,048,576 sampled rows' __CODED_ID__ (a coded
   read) against the float64 argmin over the persisted codebooks (near
   ties within 1e-5 relative allowed and counted); one Lloyd step and one
   assignment on the card against the CPU from the same codebooks and
   65,536 rows, for the trained coder and a 2 x 64 composite coder
   (codebooks within 1e-5 relative except centroids a near-tie flip
   touched, flips counted); the float64 oracle over the rows of each
   query's probe cells (those of the server's own ranking,
   executor.rank_cells, which fails the phase where it differs from a
   float64 ranking of the cells off a near tie within 1e-5 relative;
   every phase's probe cells print a probe_cells line with the count of
   queries at such a near tie) that pass the filter, held as in phase 4 (fp32 ids up to near ties,
   int8 recall@10 >= 0.99, distances within 1e-4 * max(1, d)) on every
   query of a batch up to 64 and 64 evenly spaced queries of larger ones;
   the count of queries whose probe set differs from the float64
   ranking at such a near tie; and, timed alone, the masked scan at the Q=1024 shape
   beside the unprobed phase-1 kernel at the same Q, N and D, the
   clustered gather at the Q=8 shape, one Lloyd step and one assignment
   block. No hand-written kernel serves IVF: the path's launch counts are
   read and printed (all 0).
8. selection, on the phase-3 server after phase 7: (a) three filtered
   searches, each on the device filter route (tag < 50, evaluated on the
   card: filter.device_pushdown rises by one per call, filter.host_upload
   by none) and then the host route ((tag / 1) < 50, the same rows; "/"
   keeps it on the host: the other way round): phase 3's Q=1024 l2 k=100
   (tiled K1, one launch a call), phase 3's Q=256 int8 l2 k=10 with the
   filter added (tensor_int8 K2, one launch a call) and phase 7's Q=8
   64-probe clustered search (no launch); both routes return the same ids,
   the device route the earlier phase's; warm medians (client clock,
   median of WARM_REPS) and the server's split per route, and
   cache.device_mask_builds. (b) three no-top-k reads (maxval=None,
   select=["id"]): Q=8 cosine tag == 7 (~84k rows a query), Q=8 l2
   through the coder with 16 probes and tag < 50 (the probed count pass)
   and Q=1 l2 unfiltered (the full read, every row); each moves its
   search.nomax_* counter by one and launches no kernel; rows, server and
   client times printed. (c) after the server, the oracle: each query's
   rows are exactly those of the filter (for the probed read: of the
   server's probe cells, through probe_mask) in table order, every
   distance within 1e-4 * max(1, d) of float64. (d) on the phase-6
   server, Q=8 l2 tag == 7 maxval=None over the host corpus must move
   search.residency_host_nomax and pass the same oracle.

9. IVF past the budget, on the phase-6 server after 8 (d): make_index of
   an IVF1024 l2 coder (batch 65,536, 2 epochs: 128 Lloyd steps) must
   train by streaming the host corpus in fp32 transport
   (train.stream_fp32, train.stream_steps) and assign every row on the
   host (index.host_assigns); make-coder / make-index seconds and the cell
   occupancy printed. Two probed l2 top-100 searches with residency auto,
   Q=1 with 16 probes and Q=8 with 64 probes and tag < 50, each call
   moving search.residency_probed_host by one and no kernel launch (the
   first writing the IVF sidecar), one cold and two warm calls; then
   Q=8 l2 maxval=None with 16 probes and tag == 7. After the server:
   1,048,576 rows' cell ids against the float64 argmin (near ties
   counted), one Lloyd step on the card against the CPU from the trained
   codebooks, each search against the float64 oracle over its probe
   cells' rows that pass the filter (recall@100 >= 0.99, distances within
   1e-4 * max(1, d)), the read's rows exactly the probe cells' tag == 7
   rows in table order; the host ops timed alone.
10. mutations. (a) on the phase-3 server after phase 8, with a host copy
   mutated alike as the oracle's input: append 65,536 rows (two copy
   queries of later searches): the index holds every row, the Q=8 cosine
   search grows the matrix (cache.incremental_refreshes +1, one stream
   launch, under 4x the delta's bytes uploaded) and finds its copy first,
   the Q=8 p64 clustered search finds its copy; delete tag == 7 (the
   oracle's count): the Q=1024 l2 search refreshes by the lineage (one
   tiled launch) and returns no deleted id; upsert 4,096 rows by id
   ({"replaced": 2048, "inserted": 2048}; one lineage refresh, the keep
   hop and the appended part together); compact (one lineage refresh,
   nothing uploaded). Every search against the float64 oracle by phase
   4's rule; mutation and first-search times beside phase 3's cold first
   call. (b) on the phase-6 server after phase 9: append 65,536 x 768
   rows; the auto Q=8 search quantizes exactly the delta
   (cache.mirror_rows_quantized, cache.mirror_delta_refreshes +1), grows
   the int8-resident copy (one incremental refresh, one tensor_int8
   launch), keeps no fp32 matrix and stays within the budget, recall@100
   >= 0.99 and its copy first; phase 9's Q=8 p64 search finds its copy.
   (c) stream over the grown matrix, tiled over the shrunk one and
   tensor_int8 over the grown int8 copy against their plain versions
   (check_close), with the grow, the shrink and the delta quantize timed.

11. analytics (BASELINE config 3), on the phase-3 server after phase 8:
   attrs, built as benchmarks/config3_join_aggregate.py builds it at scale
   1 (10,000,000 rows, key a permutation, grp = key % 100, a float64
   weight: every search id matches once), and attrs_dup (1,048,576 rows,
   key = i // 4, grp = i % 16, an int val) go over Flight; then each
   request of AN_REQUESTS without its join (the plain search) and with
   it, one cold and WARM_REPS warm calls each: config 3 itself (Q=1
   cosine k=128, sum(weight) by grp; fused, stream), Q=1024 l2 k=100
   tag < 50 count by grp (fused, exact int64, tiled), a Q=8 cosine
   lookup of [grp, weight] (fused, stream), Q=256 int8 mean(__DISTANCE__)
   (two-step, tensor_int8), Q=8 with phase 7's coder at 64 probes
   max(weight) (two-step, probed), and a Q=8 cosine k=100 inner join to
   attrs_dup, its rows and count by grp. Each join call moves its route's
   join.* counter by one and its kernel's launches by one. Printed: the
   first call's cache.sorted_key_seconds, each request's warm client and
   server times beside its plain search's. After the server, each plain
   search against the float64 oracle by phase 4's rule (the probed one
   over its probe cells), then its join and aggregate in numpy on the
   host copy of the attrs: integer aggregates equal and int64, float sums
   and means within 1e-5 * sum |v| of their group, min and max equal
   (of the float32 values the card holds), lookup rows the plain rows
   with the attrs gathered, inner rows in (left row, right row) order.
12. micro-batching: each case first one request at a time (a batch of
   one each: the solo answers), then from client threads, each concurrent
   table equal to its solo one; printed: the batch.* counters, requests
   and queries per dispatch, launches per request, queries/s and client
   p50 / p99 both ways. On the phase-3 server after phase 11: (a) 512
   Q=1 cosine k=10 from 32 threads (coalesced: more than one request per
   dispatch, fewer stream launches than requests); (b) the same with the
   predicates tag < 30, 30 <= tag < 70 and none by thread
   (benchmarks/config5_batched_mixed.py's rotation; at most one dispatch
   per predicate per drain); (c) Q=1024 l2 k=16 from 4 threads x 4
   requests, the predicate by round (more than 1,024 queries per
   dispatch; tiled launches and device.max_memory_allocated printed);
   (d) Q=1 l2 k=10 at 16 probes of phase 7's coder from 16 threads x 8
   requests (one probed route per dispatch). (e) on the phase-6 server
   after phase 6's searches: Q=8 auto (int8-resident) from 8 threads x 2
   requests, one int8-resident route call per dispatch, held to the
   solo answers by the graded rule (recall >= 0.99, equal distances on
   shared ids). After the servers: the result gather's vector rows of
   phase 3's Q=1024 filtered search, numpy indexing against
   native.gather_rows (host clock). Phase 2 (b) also holds the kernels at
   the largest coalesced shapes (BATCH_SHAPES: stream at Q=32, tiled at
   Q=4096) against their plain versions.

13. typed vector columns, on the phase-3 server after phase 12: items_q8,
   the phase-3 rows as a quint8 column (fenix_tpu_torch.types; its
   parameters those of one dynamic quantization of the whole matrix, the
   rows quantized batch by batch with like=), and items_t, the same fp32
   rows as a TensorType column, go over Flight. On items_q8: phase 3's
   five searches (one cold call, the table's load: codes up, dequantized
   on the card, and TY_WARM_REPS warm calls each, every call moving its
   kernel design's launches by one), the Q=8 one selecting the vector
   column, which must come back quint8 with the table's parameters and
   codes; phase 8's Q=8 cosine tag == 7 maxval=None read; make_index of
   an IVF4096 l2 coder (its column the dequantized list<float32>) and a
   Q=8 16-probe search; an append of 65,536 rows quantized with like= the
   table's type, after which a Q=8 cosine search grows the matrix (one
   incremental refresh, one stream launch) and finds 8 appended rows
   first. Distances come back float32. On items_t: phase 3's Q=8 cosine
   and Q=1024 l2 tag < 50 searches equal the same searches on items bit
   for bit (ids, distances, vectors). After the server, every items_q8
   answer against the float64 oracle over the numpy-dequantized rows by
   phase 4's rule (the probed one over its probe cells), and the card's
   dequantization of the 8,388,608 x 128 codes against numpy's, bit for
   bit, timed beside an fp32 upload of the same matrix.
14. tracing, replay and the catalog, after phase 10 (a): the phase-3
   server stops and a new one starts on the same root with
   FENIX_TRACE_DIR and FENIX_QUERY_LOG set. list_flights must name every
   table and get_flight_info give items' schema and the row count a read
   gives. Five request kinds (Q=1 cosine; Q=1024 l2 tag < 50; phase 7's
   Q=1024 64-probe IVF search; phase 8's Q=8 cosine read, at tag == 8
   since phase 10 (a) deleted the tag == 7 rows;
   BASELINE config 3's join), each once to warm up and once traced; each
   trace (a torch.profiler Chrome trace) gives the wall time of its
   fenix.rpc.search span, the union of the card's kernel, copy and memset
   intervals inside it, the idle share 1 - busy / wall, the other spans'
   times and the top device operations; a trace without kernel events
   fails. Then, with the server gone, the query log replays in this
   process on the card, every logged search matching its digest (the
   quickstart runs on the CPU tests only since the glove100 path came).

15. the serving mesh (fenix_tpu_torch/parallel): every card when the
   machine has two or more, else MESH_SHARDS = 4 shards on the one card
   (printed as "mesh": {"cards", "shards"}). (a) after phase 5, in this
   process, over a root of phase 3's rows: make-coder on the mesh
   (kmeans.train_sharded, IVF16384's config, seed 0) and make-index; then
   one device and the mesh answer, through executor.execute_search (the
   entry Flight calls), phase 3's five searches (Q=1024 on the ring, and
   again with FENIX_RING=off on the all-gather route, the two answers
   equal), MESH_READ (maxval=None, tag == 8) and MESH_IVF (phase 7's Q=8
   p64 tag < 50 and Q=1024 p64); then MESH_BATCH Q=1 requests through
   execute_search_batched, each equal to its solo answer. Every count is
   0 before the mesh path and read after it; each mesh call moves its
   route counter (search.mesh_ring / search.mesh_gather /
   search.nomax_selected / one of the search.ivf_* routes). Each mesh
   answer equals one device's, ids per query with fp32 distance ties in
   id order (the mesh merges by (distance, id), one device orders by
   score), distances within 1e-5 * max(1, d), and is held to the float64
   oracle as phases 4, 7 and 8 hold theirs. Printed: each request's time
   on the mesh beside one device's (host clock, in process) and phase 3's
   client time, the merge alone at Q=1024 k=100, ring against
   all-gather, the kernels against their plain versions at the shard
   shapes (a ring block of Q/S at Q=1024), train_sharded's seconds and
   train_sharded held to the same function over S CPU shards at
   MESH_TRAIN_CHECK's size (IVF16384 is beyond the CPU) within 1e-5 of
   the largest entry; then an append of MUT_APPEND_ROWS rows and a
   delete of tag == 9, each search after it moving the refresh counter by
   one and equal to a cold mesh cache's. (c) with two or more cards:
   each design on each card against its plain version, then a Flight
   server started with FENIX_MESH=auto answers (a)'s requests as the
   in-process mesh did, and every card launched stream, tiled,
   tensor_int8 and tensor_bf16 (the per-card launch counts). (b) on the phase-6 root
   after its server, a mesh cache and one device in process under a
   per-device MESH_BUDGET of 2 GiB (a shard's fp32 copy past it, its int8
   copy inside): MESH_RES_SEARCHES (auto must plan int8, forced int8
   Q=1024, fp32 and int8 stream Q=8, forced dual), the counters moving as
   the JAX package's mesh tests expect; fp32 answers equal one device's,
   int8 ones hold the graded rule against it, all held to the float64
   oracle over the live rows. (d) after (a)'s checks, on (a)'s mesh root
   and cache: phase 11's attrs (10,000,000 rows) and attrs_dup put in
   process, then every request of AN_REQUESTS through
   analytics.execute_search_join on one device and on the mesh, with the
   join as it stands (both tables are past FENIX_PART_ATTRS_MIN: the
   partitioned attribute route, join.partitioned one rise a call) and
   with "partitioned": false (the replicated route), one cold and
   MESH_WARM_REPS warm calls each. Every count is 0 before the mesh calls
   and read after them (the mesh_analytics path); each call moves its
   join.* route counter by one and no search.mesh_ring, and launches its
   design once per shard and nothing else (the per-card counts). Each
   mesh answer equals one device's: group keys, integer aggregates
   (int64), min and max equal, float sums and means within
   1e-5 * sum |v| of their group, lookup and inner rows equal with fp32
   distance ties in id order; where the two plain searches' winners
   differ by a near tie at the k-th place (winner_swaps, counted), each
   answer is held to its own winners instead. After the mutations, every
   mesh and one-device answer meets phase 11's float64 and numpy
   oracles. Printed: warm in-process ms on the mesh beside one device's,
   the first call's cache.parted_key_seconds and cache.sorted_key_seconds,
   the partial-table merge alone at the Q=1024 count. With several
   cards, (c)'s server also answers config 3's join as the in-process
   mesh did.
16. the shuffle (BASELINE config 4), on phase 15's mesh after its oracle
   checks, in the normal run and ``--mesh-only``. (d) first, while phase
   15's float64 oracle over phase 3's rows is up: the dim-sharded search
   on a (2, 2) mesh (four cards, else four shards on the first), Q=8
   top-10 for l2, cosine and dot, held to the oracle by phase 4's rule
   (its l2 is the expanded sqrt(|q|^2 - s), within 1e-4 * max(1, d)) and
   to the row-sharded search on phase 15's mesh (ids up to near ties),
   both timed; then kmeans.sharded_lloyd_step at phase 7's coder shapes
   (one book, rows over the data axis; two books over the model axis)
   against lloyd_step_single on one device within 1e-5 of the largest
   entry, but for centroids a float64 near tie could move. (a)
   distributed._device_shuffle_ids over SH_KEYS int64 keys (a seeded
   permutation), each shard's ids equal to the host path's
   (native.hash_partition + flatnonzero), through at the estimated
   capacity; then the same keys with their first SH_HOT of rows on one
   key: the estimate overflows and the retry at n_pad // S goes through;
   device and host seconds. (b) build_shuffle of SH_PAYLOAD_ROWS x
   SH_PAYLOAD_D fp32 rows a shard at twice the balanced share: chunks=1
   and chunks=4 bitwise equal, every row once with its key on its hash's
   shard, ms and GB/s moved. (c) distributed.repartition of (a)'s root
   table (after phase 15's mutations) into S shards on the mesh: a spy
   shows the device branch, the shard tables hold the host path's
   placement, and phase 15 (a)'s five searches and MESH_READ over the
   resolved name through executor.execute_search on a mesh cache (every
   count 0 just before, read just after: the repartition path) equal the
   answers before it, ids per query with each group of exactly tied
   fp32 distances as a set (ties now resolve by shard order; a group
   straddling the k-th place may differ within NEAR_TIE, phase 4's
   rule), distances within 1e-5 * max(1, d), and both are held to the
   float64 oracle over the live rows. With
   several cards, (c)'s FENIX_MESH=auto server of phase 15 also answers
   Flight repartition with its default shard count on a second table of
   SH_SERVER_ROWS rows (one shard a card, the host placement, the (key,
   id) upload in transfer.h2d_bytes, a search as before it).
17. multi-host, after phase 16, in the normal run and ``--mesh-only``:
   the script starts two workers of itself (``--multihost-worker``) that
   meet through ``distributed.initialize`` at a local coordinator and
   form one mesh of MH_SHARDS shards, two a process: on one card both
   workers' shards on it (gloo, through pinned host memory), on four
   cards two cards a worker (CUDA_VISIBLE_DEVICES, NCCL). The inputs are
   written once as .npy files under build/chip_smoke/ and each worker
   reads its own row range of them (the payload rows are made on each
   shard's card from its seed, as in phase 16). Every launch count is 0
   in a worker before its legs, read after them (the multihost path):
   (a) phase 3's rows, 2,097,152 a shard, with their bf16 and int8 copies
   under phase 15 (a)'s five searches; (b) the ring at phase 3's Q=1024
   l2 filtered search, each worker keeping its blocks; (c)
   kmeans.train_sharded at MESH_TRAIN_CHECK (index_add_ deterministic);
   (d) phase 16 (b)'s payload exchange at chunks 1 and 4, then the id
   shuffle of phase 3's row count with SH_HOT of the keys on one: an
   overflow, then the retry, in step on both workers; (e) config 3's
   attribute side partitioned over the shards (DeviceCache.parted_key's
   layout) under MH_JOINS (the Q=1024 count and the Q=1 float sum); (f)
   the streaming scan of phase 3's rows in 4 chunks at Q=8; (g) the
   dim-sharded search on a (2, 2) mesh at Q=8 for DIM_METRICS. Each leg
   one call and MH_REPS warm ones. After the workers exit, the script
   runs the same legs on its own one-process mesh of the same four
   shards and requires every replicated array equal on both workers and
   to its own, bitwise, each shard's own (the ring's blocks in block
   order, the payload's digests, the id shuffle's ids) on its owner
   alike; the id shuffle's placement the host hash's; the searches, the
   ring, the stream and the dim-sharded search held to a float64 oracle
   by phase 4's rule. Printed: the backend, each leg's warm ms in each
   worker beside one process's, each worker's launches per design. A
   worker that fails or outlives MH_TIMEOUT_S is killed and the script
   fails. The shard shapes are phase 15's, whose kernel rows hold them.

Then one JSON line of the kernels (the five designs: stream and tiled
for K1 in f32, tensor_bf16 for K1 in bf16, tensor_int8 and generic_int8
for K2, and K3 as f32 at bucket 128,
each with its launches on every path: exact, residency, ivf, selection,
mutation, analytics, batching, types, mesh, mesh_analytics, repartition,
multihost), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no
result. With no arguments it runs every phase on one card (a machine with
several runs them on the first, and phases 15 to 17 over all of them);
``--mesh-only`` runs phase 1's build and phases 15 to 17 alone ((b) on
phase 6's rows put in process), the run for a machine with several cards.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # the card every phase runs on
ROWS = 8_388_608  # the table of phase 3
KERNEL_ROWS = 1 << 20  # the kernel-vs-plain inputs of phase 2 (a)
D = 128
DUP = 4096  # rows DUP..2*DUP-1 copy rows 0..DUP-1
BATCH_ROWS = 65_536
NEAR_TIE = 1e-5  # relative float64 distance gap below which fp32 order is free
TIMING_REPS = 3  # timed launches per kernel-vs-plain shape, after one warm-up
WARM_REPS = 5  # warm repetitions per search
RES_WARM_REPS = 2  # warm repetitions of a phase-6 search (several seconds each on the host)
SEARCHES = (
    # name, queries, metric, k, precision, filtered, flat
    ("flat_cosine_k10", 1, "cosine", 10, "fp32", False, True),
    ("q8_cosine_k10", 8, "cosine", 10, "fp32", False, False),
    ("q1024_l2_k100_filtered", 1024, "l2", 100, "fp32", True, False),
    ("q64_bf16_cosine_k10", 64, "cosine", 10, "bf16", False, False),
    ("q256_int8_l2_k10", 256, "l2", 10, "int8", False, False),
)
ROUTES = {"fp32": "f32", "bf16": "bf16", "int8": "int8"}
K3_ROUTE = "f32.bucket128"  # f32 launches at bucket 128 also serve K3
# LAUNCHES["bucket_scores.kernel.<design>"]
DESIGNS = ("stream", "tiled", "tensor_int8", "generic_int8", "tensor_bf16", "generic_bf16")
INT8_DESIGNS = ("tensor_int8", "generic_int8")
BF16_DESIGNS = ("tensor_bf16", "generic_bf16")  # the bf16 designs on the tensor cores
KERNELS = (
    # name in the kernels line, launch-count key, source, TPU kernel it
    # replaces, paths that must launch it
    ("bucket_scores.kernel.stream", "kernel.stream", "fenix_tpu_torch/csrc/bucket_scores_stream.cu",
     "fenix_tpu/ops/topk2.py:453", ("exact", "residency", "mutation", "analytics", "batching", "types", "mesh",
                                    "mesh_analytics", "repartition", "multihost")),
    ("bucket_scores.kernel.tiled", "kernel.tiled", "fenix_tpu_torch/csrc/bucket_scores_tiled.cu",
     "fenix_tpu/ops/topk2.py:453", ("exact", "selection", "mutation", "analytics", "batching", "types", "mesh",
                                    "mesh_analytics", "repartition", "multihost")),
    ("bucket_scores.kernel.tensor_int8", "kernel.tensor_int8", "fenix_tpu_torch/csrc/bucket_scores_tensor.cu",
     "fenix_tpu/ops/topk2.py:464", ("exact", "residency", "selection", "mutation", "analytics", "types", "mesh",
                                    "mesh_analytics", "repartition", "multihost")),
    # every bf16 search: phase 3's Q=64, and on the typed table, the mesh,
    # the repartitioned table and the multi-host workers
    ("bucket_scores.kernel.tensor_bf16", "kernel.tensor_bf16", "fenix_tpu_torch/csrc/bucket_scores_tensor.cu",
     "fenix_tpu/ops/topk2.py:453", ("exact", "types", "mesh", "repartition", "multihost")),
    # int8 and bf16 rows that are not 16-byte strided: the glove100 table's
    ("bucket_scores.kernel.generic_int8", "kernel.generic_int8", "fenix_tpu_torch/csrc/bucket_scores_tensor.cu",
     "fenix_tpu/ops/topk2.py:464", ("glove100",)),
    ("bucket_scores.kernel.generic_bf16", "kernel.generic_bf16", "fenix_tpu_torch/csrc/bucket_scores_tensor.cu",
     "fenix_tpu/ops/topk2.py:453", ("glove100",)),
    ("bucket_scores.f32@bucket128", K3_ROUTE, "fenix_tpu_torch/csrc/bucket_scores_stream.cu",
     "fenix_tpu/ops/topk2.py:357", ("exact", "residency", "mesh", "repartition", "multihost")),  # K3
)
# phases 3-5, the exact narrow path ("glove100" in the kernels line), on
# the phase-3 server: the shape of ann-benchmarks' glove-100-angular
# (Aumueller, Bernhardsson and Faithfull, ANN-Benchmarks: 1,183,514 x 100,
# angular, 10,000 test queries) at the dataset's own row count; random
# normal rows from the script's seed (nothing is downloaded) with an int32
# tag, duplicate rows as in phase 3. 100 int8 or bf16 values are not a
# multiple of 16 bytes, so TMA cannot address the rows: the generic
# designs serve both scans.
GLOVE_TABLE = "smoke/glove100"
GLOVE_ROWS = 1_183_514
GLOVE_D = 100
GLOVE_BLOCK = 16_384  # the engine's row block (engine/session.py): it scans whole blocks
GLOVE_SEARCHES = (
    # name, queries, metric, k, precision, filtered, flat
    ("glove_q8_int8_cosine_k10", 8, "cosine", 10, "int8", False, False),
    ("glove_q1024_int8_cosine_k100_filtered", 1024, "cosine", 100, "int8", True, False),
    ("glove_q64_bf16_cosine_k10", 64, "cosine", 10, "bf16", False, False),
    ("glove_q1024_bf16_cosine_k100", 1024, "cosine", 100, "bf16", False, False),
)
GLOVE_DIST_TOL = 1e-5  # phase 2 rescores fp32-true: distances within 1e-5 * max(1, d) of float64
# phase 2 (a): edge shapes, each design against the plain version
EDGE_Q = (1, 2, 7, 8, 9, 16, 17, 32, 33, 64, 65)
EDGE_Q_INT8 = EDGE_Q + (100, 200, 257, 1024)  # the tensor cores also: 128- and 256-query tiles, several
# 25, 100, 130 and 301 are not a multiple of 16 bytes of int8, bf16 or f32; 25 and 301 of 4 bytes of int8
EDGE_D = (25, 96, 100, 130, 301, 768)
EDGE_BUCKETS = (1, 2, 32, 128)
# phase 2 (b): f32/bf16 designs forced at ROWS x D: (route, query count, D, designs)
FORCED = (
    *(("f32", q, D, ("stream", "tiled")) for q in (1, 8, 16, 32, 64)),
    *(("f32", q, D, ("stream",)) for q in (12, 24)),  # the outer-product groups between 8 and 32
    ("f32", 128, D, ("stream", "tiled")),  # where stream hands over to tiled
    *(("bf16", q, D, ("tensor_bf16",)) for q in (1, 8, 16, 32, 64, 256, 1024)),
    # rows TMA cannot address, beside the rows it can at the same Q
    *(("bf16", q, GLOVE_D, ("generic_bf16",)) for q in (1, 8, 32, 64, 256, 1024)),
)
# phase 2 (b): each int8 design forced at these (rows, D) over these query
# counts (tensor_int8 where D is a multiple of 16)
FORCED_INT8 = ((8_388_608, 128), (8_388_608, GLOVE_D), (4_194_304, 768))
FORCED_INT8_Q = (1, 8, 16, 32, 64, 256, 1024)
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): HBM3 read rate, fp32 on the CUDA cores, bf16 and int8 on
# the tensor cores.
PEAK_READ = 3.35e12  # bytes/s
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}  # operations/s
ESIZE = {"f32": 4, "bf16": 2, "int8": 1}
D768_SHAPES = ((8, 128, "f32"), (8, 128, "int8"), (1024, 32, "int8"))  # phase 2 (c): q, bucket, route

# phase 6: BASELINE config 2's widths (exact top-100 l2, scalar filter, D=768),
# cut from 10M to 4,194,304 rows, served past a 6 GiB budget
RES_ROWS = 4_194_304
RES_D = 768
RES_BUDGET = 6 << 30
RES_K = 100
RES_SEARCHES = (
    # name, queries, residency, precision, route, launches per call, counter, rise per call
    ("auto_q8", 8, "auto", "fp32", "int8", 1, "search.residency_int8", 1),
    ("int8_q1024", 1024, "int8", "fp32", "int8", 1, "search.residency_int8", 1),
    ("stream_q8", 8, "stream", "fp32", "f32", 10, "search.stream_chunks", 10),
    ("stream_int8_q64", 64, "stream", "int8", "int8", 3, "search.stream_chunks", 3),
    ("dual_q8", 8, "dual", "fp32", "f32", 1, None, 0),
)
RES_INT8_GRADED = ("auto_q8", "int8_q1024", "stream_int8_q64")  # held to recall, not order
SPLIT_KEYS = (
    "search.seconds", "residency.phase_a_seconds", "residency.rescore_seconds",
    "transfer.h2d_bytes", "transfer.h2d_seconds", "transfer.stage_seconds",
    "transfer.wait_seconds",
)

# phase 7: IVF16384 over the phase-3 table, inside the FAISS guideline of
# 4*sqrt(N) to 16*sqrt(N) cells (11,585-46,341 at 8,388,608 rows; faiss
# wiki, "Guidelines to choose an index")
IVF_CODER = "ivf16k"
IVF_CELLS = 16_384
IVF_CONFIG = {"metric": "l2", "codebook_size": IVF_CELLS, "num_codebooks": 1,
              "batch_size": 65_536, "num_epochs": 2}
IVF_K = 10
IVF_SEARCHES = (
    # name, queries, probes, filtered, precision, route, metric sent (None: the coder's)
    ("ivf_q1_p16", 1, 16, False, "fp32", "clustered", None),
    ("ivf_q8_p64_filtered", 8, 64, True, "fp32", "clustered", "l2"),
    ("ivf_q1024_p64", 1024, 64, False, "fp32", "scan", None),
    ("ivf_q256_p64_int8", 256, 64, False, "int8", "scan", "l2"),
)
IVF_ROUTES = {"clustered": "search.ivf_clustered", "scan": "search.ivf_scan"}
IVF_SPLIT_KEYS = ("search.seconds", "ivf.rank_seconds", "ivf.route_seconds")
IVF_SAMPLE_ROWS = 1 << 20  # rows of the assignment check
IVF_STEP_ROWS = 65_536  # rows of the Lloyd-step check
IVF_CHECKED = 64  # queries of a larger batch held to the oracle, evenly spaced
CELL_TIE = 1e-5  # cells whose float64 distances lie this close may rank either way in fp32
IVF_TIMED = {"masked_scan": "ivf_q1024_p64", "clustered": "ivf_q8_p64_filtered"}  # timed alone

# phase 8: selection, on the phase-3 server and table after phase 7 (the
# host read on the phase-6 server). (a) filtered searches on both filter
# routes: the predicate tag < 50 runs on the card; (tag / 1) < 50 selects
# the same rows, but "/" keeps it on the host
SEL_PUSHDOWN = (
    # name, the earlier search it reruns (phase 3 or 7), filtered there
    ("pushdown_q1024_l2_k100", "q1024_l2_k100_filtered"),
    ("pushdown_q256_int8_l2_k10", "q256_int8_l2_k10"),  # phase 3's int8 search, tag < 50 added
    ("pushdown_ivf_q8_p64", "ivf_q8_p64_filtered"),
)
SEL_ROUTES = {"device": "filter.device_pushdown", "host": "filter.host_upload"}
SEL_SPLIT_KEYS = ("search.seconds", "filter.seconds")
# (b) no-top-k reads (maxval=None): name, queries, metric, tag predicate
# ("==", v) / ("<", v) or None, probes of the phase-7 coder or None
SEL_READS = (
    ("read_q8_cosine_tag_eq_7", 8, "cosine", ("==", 7), None),  # ~84k rows a query
    ("read_q8_l2_p16_tag_lt_50", 8, "l2", ("<", 50), 16),  # the probed count pass
    ("read_q1_l2_full", 1, "l2", None, None),  # every row: 8,388,608
)
SEL_READ_REPS = 3  # warm calls per read
SEL_HOST_READ = ("read_host_q8_l2_tag_eq_7", 8, "l2", ("==", 7), None)  # (d), phase-6 server
SEL_ORACLE_ROWS = 1 << 20  # rows per float64 distance check step
ALL_LAUNCH_KEYS = (*ROUTES.values(), K3_ROUTE, *(f"kernel.{k}" for k in DESIGNS))

# phase 9: IVF past the budget on the phase-6 server (4,194,304 x 768 past
# 6 GiB); the fp32 form (12.9 GB) passes 0.9 x the budget, so the coder
# trains by streaming and the rows are assigned on the host. IVF1024 =
# sqrt(N) / 2: cut from IVF8192 = 4*sqrt(N), the lower edge of FAISS's
# 4*sqrt(N) to 16*sqrt(N) (faiss wiki, "Guidelines to choose an index"),
# because the host assignment at 8,192 cells took 602 s on the card's host
# and at 4,096 cells ~90-100 s, the most of any phase, when phase 17 came;
# then to 1,024 cells (from 2,048, 45 s) when the glove100 path came and a
# slower host took the whole run to 92 % of its limit
IVFH_CODER = "ivf1k"
IVFH_CELLS = 1024
IVFH_CONFIG = {"metric": "l2", "codebook_size": IVFH_CELLS, "num_codebooks": 1,
               "batch_size": 65_536, "num_epochs": 2}
IVFH_K = 100
IVFH_SEARCHES = (
    # name, queries, probes, filtered (tag < 50); l2 top-100, residency auto
    ("host_ivf_q1_p16", 1, 16, False),
    ("host_ivf_q8_p64_filtered", 8, 64, True),
)
IVFH_READ = ("host_ivf_read_q8_l2_p16_tag_eq_7", 8, "l2", ("==", 7), 16)  # maxval=None
IVFH_STEP_ROWS = 65_536  # rows of the Lloyd-step check: one step of a streamed chunk
# the server's split of a probed host search: the int8 scan of the probe
# cells and the exact rescore of the window
IVFH_SPLIT_KEYS = ("residency.probed_score_seconds", "residency.rescore_seconds")

# phase 10: mutations. (a) on the phase-3 server: append, delete tag == 7,
# upsert by id, compact; (b) on the phase-6 server: append
MUT_APPEND_ROWS = 65_536
MUT_UPSERT = 2_048  # existing ids given new vectors, and as many new ids
MUT_H2D_FACTOR = 4  # the append's refresh uploads under this many times its delta

# phase 11: analytics on the phase-3 server, BASELINE config 3 ("kNN over
# embeddings joined to a 10M-row attributes table, hash aggregate over
# match groups"), attrs built as benchmarks/config3_join_aggregate.py
# builds it at scale 1; attrs_dup for the inner join
AN_ATTRS_ROWS = 10_000_000
AN_DUP_ROWS = 1_048_576
AN_BATCH_ROWS = 1 << 20  # rows per ingest batch
AN_JOIN = {"source": "attrs", "right_on": "key"}
AN_DUP_JOIN = {"source": "attrs_dup", "right_on": "key", "how": "inner"}
AN_REQUESTS = (
    # name, queries, metric, k, precision, filtered (tag < 50), probes of
    # phase 7's coder, join, aggregate, route counter, query seed
    ("config3_q1_cosine_k128_sum_weight", 1, "cosine", 128, "fp32", False, None, AN_JOIN,
     {"group_by": "grp", "value": "weight", "agg": "sum", "max_groups": 128}, "join.fused", 500),
    ("q1024_l2_k100_tag_lt_50_count", 1024, "l2", 100, "fp32", True, None, AN_JOIN,
     {"group_by": "grp", "agg": "count", "max_groups": 128}, "join.fused", 501),
    ("q8_cosine_k10_lookup", 8, "cosine", 10, "fp32", False, None, {**AN_JOIN, "columns": ["grp", "weight"]},
     None, "join.fused", 502),
    ("q256_int8_l2_k10_mean_distance", 256, "l2", 10, "int8", False, None, AN_JOIN,
     {"group_by": "grp", "value": "__DISTANCE__", "agg": "mean", "max_groups": 128}, "join.two_step", 503),
    ("q8_l2_k10_p64_max_weight", 8, "l2", 10, "fp32", False, 64, AN_JOIN,
     {"group_by": "grp", "value": "weight", "agg": "max", "max_groups": 128}, "join.two_step", 504),
    ("q8_cosine_k100_inner_dup", 8, "cosine", 100, "fp32", False, None, AN_DUP_JOIN, None, "join.inner", 505),
    ("q8_cosine_k100_inner_dup_count", 8, "cosine", 100, "fp32", False, None, AN_DUP_JOIN,
     {"group_by": "grp", "agg": "count", "max_groups": 16}, "join.inner", 505),
)

# phase 12: micro-batching, (a)-(d) on the phase-3 server, (e) on the
# phase-6 server. Predicates by thread, as benchmarks/config5_batched_mixed.py
# rotates three classes: tag < 30, 30 <= tag < 70, none
MB_THREADS = 32
MB_Q1_REQUESTS = 512
MB_PREDICATES = (("<", 30), ("range", 30, 70), None)
MB_BIG = (4, 4, 1024, 16)  # (c): threads, requests per thread, queries, k (config 5's batch and k)
MB_PROBED = (16, 8, 16)  # (d): threads, requests per thread, probes of phase 7's coder
MB_RES = (8, 2, 8)  # (e): threads, requests per thread, queries
# phase 2 (b): the kernels at the largest coalesced shapes of phase 12
# phase 13: typed vector columns, on the phase-3 server after phase 12
TY_Q8 = "smoke/items_q8"  # the phase-3 rows as a quint8 column: 1 GiB of codes at rest
TY_T = "smoke/items_t"  # the same fp32 rows as a TensorType column
TY_CODER = "ivf4k_q8"
TY_CELLS = 4096  # 1.4·√N: cut from FAISS's 4·√N–16·√N for the run's time
TY_CONFIG = {"metric": "l2", "codebook_size": TY_CELLS, "num_codebooks": 1, "batch_size": 65_536,
             "num_epochs": 2}
TY_WARM_REPS = 3  # warm calls per search
TY_SELECT = "q8_cosine_k10"  # the phase-3 search that also selects the quint8 vector column
TY_READ = ("q8_read_q8_cosine_tag_eq_7", 8, "cosine", ("==", 7), None)  # maxval=None, as phase 8's first read
TY_PROBED = ("q8_ivf4k_q8_l2_p16", 8, 16)  # name, queries, probes (k = IVF_K)
TY_APPEND_ROWS = 65_536
TY_T_SEARCHES = ("q8_cosine_k10", "q1024_l2_k100_filtered")  # held bit-equal on items_t and items

# phase 14: tracing, replay and the catalog, on a new server over the same
# root after phase 10 (a): one warm-up and one traced call per kind
# phase 8's first read with another tag: phase 10 (a) deleted the tag == 7 rows
TR_READ = ("read_q8_cosine_tag_eq_8", 8, "cosine", ("==", 8), None)
TR_SPANS = ("fenix.rpc.search", "fenix.snapshot", "fenix.fetch", "fenix.rank_cells", "fenix.mask_build",
            "fenix.result_gather")
TR_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a torch.profiler trace
TR_TOP_OPS = 5

# phase 15: the serving mesh: every card when there are several, else
# MESH_SHARDS shards on the one card. (a) on a root of phase 3's rows
MESH_SHARDS = 4
MESH_WARM_REPS = 3  # warm calls per request, on the mesh and on one device
MESH_READ = ("mesh_read_q8_cosine_tag_eq_8", 8, "cosine", ("==", 8), None)  # maxval=None
MESH_IVF = (
    # name, queries, probes of phase 7's coder, filtered (tag < 50), route expected
    ("ivf_q8_p64_filtered", 8, 64, True, "clustered"),
    ("ivf_q1024_p64", 1024, 64, False, "scan"),
)
MESH_BATCH = 32  # Q=1 cosine k=10 requests through execute_search_batched
# train_sharded on the card against the CPU: IVF16384 is beyond the CPU,
# so the held run is 131,072 of the rows at 1,024 cells (8 Lloyd steps)
MESH_TRAIN_CHECK = {"rows": 131_072, "config": {"metric": "l2", "codebook_size": 1024, "num_codebooks": 1,
                                                "batch_size": 16_384, "num_epochs": 1}}
# (b) on the phase-6 root, a per-device budget at which a shard's fp32 copy
# does not fit (3.2 GiB at 4 shards) and its int8 copy does (0.8 GiB)
MESH_BUDGET = 2 << 30
MESH_RES_SEARCHES = (
    # name, queries, residency, precision, counter (one rise a call; a chunk's
    # for the stream), the window (None: the default): the mesh rescores S
    # windows a query, so Q=1024 runs at a quarter of the default
    ("mesh_auto_q8", 8, "auto", "fp32", "search.residency_int8", None),
    ("mesh_int8_q1024", 1024, "int8", "fp32", "search.residency_int8", 1024),
    ("mesh_stream_q8", 8, "stream", "fp32", "search.stream_chunks", None),
    ("mesh_stream_int8_q8", 8, "stream", "int8", "search.stream_chunks", None),
    ("mesh_dual_q8", 8, "dual", "fp32", None, None),
)

# phase 16: the shuffle, the mesh branch of repartition, the dim-sharded
# search and the sharded Lloyd step, on phase 15's mesh after its checks
SH_KEYS = 100_000_000  # (a): BASELINE config 4's row count, a seeded permutation
SH_HOT = 0.3  # (a): the skewed set's share of rows on one key, its first rows
SH_PAYLOAD_ROWS = 262_144  # (b): rows per shard
SH_PAYLOAD_D = 768  # (b): BASELINE config 2/4's width
SH_REPS = 3  # (b): timed exchanges per chunking, after the checked one
SH_SERVER_ROWS = 1 << 20  # (c), several cards: the second table of the Flight repartition
DIM_Q, DIM_K = 8, 10  # (d): queries and k of the dim-sharded search
DIM_METRICS = ("l2", "cosine", "dot")

# phase 17: multi-host, two worker processes of this script on torch.distributed
MH_PROCS = 2  # worker processes, two shards each: phase 15's four
MH_SHARDS = 4
MH_REPS = 3  # warm calls per leg, after the first
MH_TIMEOUT_S = 420  # the workers' limit, start to exit
MH_INIT_TIMEOUT_S = 180  # initialize's rendezvous and every collective
MH_STREAM = (8, "l2", 10, 4)  # (f): queries, metric, k, chunks of phase 3's rows
MH_JOINS = ("q1024_l2_k100_tag_lt_50_count", "config3_q1_cosine_k128_sum_weight")  # (e), of AN_REQUESTS
MH_DIGEST_WORDS = 1 << 24  # (d): int32 words a digest block sums

BATCH_SHAPES = (
    ("batch_q32_cosine_k10", MB_THREADS, "cosine", 10, "fp32", False, False),
    ("batch_q4096_l2_k16_filtered", 4096, "l2", 16, "fp32", True, False),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(rows: int, seed: int, dim: int = D):
    import numpy as np

    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((rows, dim), dtype=np.float32)
    dup = min(DUP, rows // 2)
    vectors[dup : 2 * dup] = vectors[:dup]
    ids = np.arange(rows, dtype=np.int64)
    tags = rng.integers(0, 100, rows, dtype=np.int32)
    return vectors, ids, tags


def make_queries(vectors, q: int, seed: int, src_pool=None):
    """Half of each batch are noisy copies of duplicated rows (drawn from
    ``src_pool`` when given), so the exact duplicate pairs tie at the top
    of their results."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dim = vectors.shape[1]
    queries = rng.standard_normal((q, dim), dtype=np.float32)
    near = q - q // 2
    dup = min(DUP, vectors.shape[0] // 2)
    src = rng.integers(0, dup, near) if src_pool is None else rng.choice(src_pool, near)
    queries[:near] = vectors[src] + 0.05 * rng.standard_normal((near, dim), dtype=np.float32)
    return queries


# -- phase 2: kernel vs plain -------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_chunked(kernels, q, v, mul, add, bucket, inv_sq, chunk: int = 128):
    """The plain version over query chunks (row-independent per query),
    so its [Q, N] score matrix fits the card at main-path sizes."""
    import torch

    parts = []
    for s in range(0, q.shape[0], chunk):
        isq = inv_sq[s : s + chunk] if inv_sq is not None else None
        parts.append(kernels.bucket_scores_plain(q[s : s + chunk], v, mul, add, bucket, isq))
    return torch.cat(parts)


def check_close(got, want, q, v, mul, add, inv_sq) -> float:
    """Hold the kernel's maxima ``got`` against the plain version's
    ``want`` with the tolerances of the module docstring; return the
    largest difference over finite buckets."""
    import torch

    finite_add = add[torch.isfinite(add)]
    add_max = float(finite_add.abs().max()) if finite_add.numel() else 0.0
    if inv_sq is None:
        row = float((v.float().norm(dim=1) * mul.abs()).max())
        tol = 1e-5 * q.float().norm(dim=1) * row + 1e-6 * add_max
    else:
        l1 = q.to(torch.float32).abs().sum(dim=1)
        tol = 2e-6 * (127.0 * l1 * float(mul.abs().max()) + add_max * inv_sq)
    if torch.isnan(got).any():
        raise AssertionError("kernel produced NaN")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("kernel and plain version disagree on -inf buckets")
    fin = torch.isfinite(want)
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    err = float(diff.max()) if diff.numel() else 0.0
    over = diff > tol[:, None]
    if over.any():
        raise AssertionError(f"kernel off by {err} (> tolerance at {int(over.sum())} buckets)")
    return err


def bound(route: str, q: int, n: int, d: int, bucket: int) -> dict:
    """The least time the card could take for one phase-1 call: the
    larger of its bytes (V and Q read once, the two f32 aux vectors, int8's
    inv_sq, the f32 output written once) over the read rate and its
    2·Q·N·D operations over the peak rate of their type."""
    nbytes = (n + q) * d * ESIZE[route] + 8 * n + 4 * q * (n // bucket)
    if route == "int8":
        nbytes += 4 * q
    ops = 2 * q * n * d
    read_ms = nbytes / PEAK_READ * 1e3
    ops_ms = ops / PEAK_OPS[route] * 1e3
    if read_ms >= ops_ms:
        return {"bound_ms": read_ms, "bound_by": "read", "bytes": nbytes, "ops": ops}
    return {"bound_ms": ops_ms, "bound_by": route, "bytes": nbytes, "ops": ops}


def library_fn(q, v, chunk: int = 128):
    """One PyTorch call for the product alone, over the query chunks of
    ``plain_chunked``: ``torch.matmul`` (TF32 off) for f32 and bf16,
    ``torch._int_mm`` for int8. ``_int_mm`` takes more than 16 rows on its
    left and widths that are multiples of 8, so a chunk of 16 queries or
    fewer goes on its right (``V8 · Q8ᵀ``, ``Q8ᵀ`` a view: the card took it
    and ran it faster than a contiguous copy); None where a chunk fits
    neither way. A width that is not a multiple of 8 is zero-padded to one:
    the padded copies of Q8 and V8, made here and not in the timed call,
    give the same products."""
    import torch

    if q.dtype != torch.int8:
        def run():
            for s in range(0, q.shape[0], chunk):
                torch.matmul(q[s : s + chunk], v.T)

        return run
    qt, d = q.shape
    sizes = [min(chunk, qt - s) for s in range(0, qt, chunk)]
    if v.shape[0] % 8 or any(m <= 16 and (m % 8 or v.shape[0] <= 16) for m in sizes):
        return None
    if d % 8:
        q, v = (torch.nn.functional.pad(x, (0, -d % 8)) for x in (q, v))

    def run_int8():
        for s in range(0, qt, chunk):
            c = q[s : s + chunk]
            if c.shape[0] > 16:
                torch._int_mm(c, v.T)
            else:
                torch._int_mm(v, c.T)

    return run_int8


def check_kernel(kernels, q, v, mul, add, bucket, inv_sq, kernel):
    """A kernel design against its plain version on the card: the largest
    difference and the kernel's maxima."""
    import torch

    got = kernels.bucket_scores(q, v, mul, add, bucket, inv_sq=inv_sq, _kernel=kernel)
    want = plain_chunked(kernels, q, v, mul, add, bucket, inv_sq)
    if got.is_cuda:
        torch.cuda.synchronize()
    return check_close(got, want, q, v, mul, add, inv_sq), got


def design_diff(kernels, got, q, v, mul, add, bucket, inv_sq, design) -> dict:
    """An int8 design's maxima ``got`` against the other int8 design at the
    same inputs. Both sum exactly in integers and spell out the epilogue's
    one FMA, so they must agree bit for bit."""
    import torch

    other = INT8_DESIGNS[1 - INT8_DESIGNS.index(design)]
    if other == "tensor_int8" and v.shape[1] % 16:
        return {}
    theirs = kernels.bucket_scores(q, v, mul, add, bucket, inv_sq=inv_sq, _kernel=other)
    if theirs.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, theirs):
        diff = float(torch.where(torch.isfinite(got), (got - theirs).abs(), torch.zeros_like(got)).max())
        raise AssertionError(f"{design} and {other} differ by {diff}: the int8 designs must be bit-equal")
    return {"other_design": other, "designs_bit_equal": True}


def compare(kernels, q, v, mul, add, bucket, inv_sq, kernel=None) -> dict:
    """A kernel against its plain version on the card, then the kernel, the
    plain version and the library call timed; ``kernel`` forces a design."""
    import torch

    route = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}[v.dtype]
    design = kernel or kernels.kernel_for(v.dtype, q.shape[0], v.shape[1])
    err, got = check_kernel(kernels, q, v, mul, add, bucket, inv_sq, design)
    designs = design_diff(kernels, got, q, v, mul, add, bucket, inv_sq, design) if route == "int8" else {}
    del got
    ms = time_ms(lambda: kernels.bucket_scores(q, v, mul, add, bucket, inv_sq=inv_sq, _kernel=design),
                 TIMING_REPS)
    plain_ms = time_ms(lambda: plain_chunked(kernels, q, v, mul, add, bucket, inv_sq), TIMING_REPS)
    lib = library_fn(q, v)
    b = bound(route, q.shape[0], v.shape[0], v.shape[1], bucket)
    return {"kernel": design, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None if lib is None else time_ms(lib, TIMING_REPS),
            **b, "share_of_bound": b["bound_ms"] / ms, **designs}


def phase_kernel_vs_plain(kernels, topk2) -> list[dict]:
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    n, device = KERNEL_ROWS, DEVICE
    v32 = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).to(device)
    mul = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
    add = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    add[torch.from_numpy(rng.random(n) < 0.1).to(device)] = float("-inf")
    add[: 4 * 128] = float("-inf")  # whole buckets of masked rows
    v16 = v32.to(torch.bfloat16)
    v8, sv = topk2.quantize_corpus_int8(v32)
    results = []
    for qn in (1, 8, 100, 1024):
        q32 = torch.from_numpy(rng.standard_normal((qn, D), dtype=np.float32)).to(device)
        for bucket in (128, 32):
            for route in ("f32", "bf16", "int8"):
                if route == "f32":
                    args = (q32, v32, mul, add, bucket, None)
                elif route == "bf16":
                    args = (q32.to(torch.bfloat16), v16, mul, add, bucket, None)
                else:
                    q8, inv_sq = topk2.quantize_queries_int8(q32)
                    args = (q8, v8, mul * sv, add, bucket, inv_sq)
                r = compare(kernels, *args)
                results.append({"route": route, "q": qn, "n": n, "bucket": bucket, **r})
    return results


def edge_rows(bucket: int) -> int:
    """Rows of an edge-shape table: not a multiple of the 128-row tile
    where the bucket allows it (N must stay a multiple of the bucket)."""
    return 16_384 + 96 if bucket <= 32 else 16_384 + 128


def phase_edge_shapes(kernels, topk2) -> dict:
    """Phase 2 (a), edge shapes: every design against the plain version
    over EDGE_Q (the int8 and bf16 designs: EDGE_Q_INT8) x EDGE_D x
    EDGE_BUCKETS, untimed; where both int8 designs run, they are also
    bit-equal."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(5)
    checked, err, bit_equal = 0, 0.0, 0
    for d in EDGE_D:
        for bucket in EDGE_BUCKETS:
            n = edge_rows(bucket)
            v32 = torch.randn((n, d), generator=g, device=DEVICE)
            mul = torch.rand(n, generator=g, device=DEVICE) + 0.5
            add = torch.randn(n, generator=g, device=DEVICE)
            add[torch.rand(n, generator=g, device=DEVICE) < 0.1] = float("-inf")
            add[: 2 * bucket] = float("-inf")  # two whole buckets of masked rows
            v16 = v32.to(torch.bfloat16)
            v8, sv = topk2.quantize_corpus_int8(v32)
            for qn in EDGE_Q_INT8:
                q32 = torch.randn((qn, d), generator=g, device=DEVICE)
                q8, inv_sq = topk2.quantize_queries_int8(q32)
                cases = []
                if qn in EDGE_Q:
                    cases += [(q32, v32, None, k) for k in ("stream", "tiled")]
                cases += [(q32.to(torch.bfloat16), v16, None, k) for k in BF16_DESIGNS if k != "tensor_bf16" or d % 8 == 0]
                cases += [(q8, v8, inv_sq, k) for k in INT8_DESIGNS if k != "tensor_int8" or d % 16 == 0]
                outs = {}
                for q, v, isq, kernel in cases:
                    m = mul * sv if isq is not None else mul
                    e, outs[kernel] = check_kernel(kernels, q, v, m, add, bucket, isq, kernel)
                    err = max(err, e)
                    checked += 1
                if "tensor_int8" in outs and not torch.equal(outs["tensor_int8"], outs["generic_int8"]):
                    raise AssertionError(f"int8 designs differ at Q={qn}, D={d}, bucket {bucket}")
                bit_equal += "tensor_int8" in outs
    return {"checked": checked, "q": EDGE_Q, "q_int8": EDGE_Q_INT8, "d": EDGE_D, "buckets": EDGE_BUCKETS,
            "max_abs_err": err, "int8_designs_bit_equal": bit_equal}


def phase_forced(kernels, topk2, vectors) -> list[dict]:
    """Phase 2 (b): the f32/bf16 designs, each forced, at ROWS x D (cosine
    aux, random queries; phase 3's rows at D, rows drawn on the card at any
    other D) at the query counts of FORCED."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    rows = []
    for d in sorted({f[2] for f in FORCED}):
        corpus = (torch.from_numpy(vectors).to(DEVICE) if d == D
                  else torch.randn((ROWS, d), generator=g, device=DEVICE))
        mul, add = topk2.prepare_aux(corpus, None, "cosine")
        for route in ("f32", "bf16"):
            dtype = torch.float32 if route == "f32" else torch.bfloat16
            v = corpus if route == "f32" else corpus.to(dtype)
            for _, qn, _, designs in (f for f in FORCED if f[0] == route and f[2] == d):
                q = torch.from_numpy(rng.standard_normal((qn, d), dtype=np.float32)).to(DEVICE)
                qp = topk2.prepare_queries(q, "cosine").to(dtype).contiguous()
                bucket = topk2.bucket_for(qn, ROWS)
                for kernel in designs:
                    rows.append({"route": route, "q": qn, "n": ROWS, "d": d, "bucket": bucket,
                                 **compare(kernels, qp, v, mul, add, bucket, None, kernel=kernel)})
                    emit({"phase": "kernel_forced", **rows[-1]})
            del v
        del corpus, mul, add
        torch.cuda.empty_cache()
    return rows


def phase_forced_int8(kernels, topk2) -> list[dict]:
    """Phase 2 (b), int8: both int8 designs forced at the (rows, D) of
    FORCED_INT8 (l2 aux of random normal rows, random queries) over
    FORCED_INT8_Q (tensor_int8 where D is a multiple of 16); the timings
    behind kernels.kernel_for's int8 rule."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(4)
    rows = []
    for n, d in FORCED_INT8:
        v32 = torch.randn((n, d), generator=g, device=DEVICE)
        mul, add = topk2.prepare_aux(v32, None, "l2")
        v8, sv = topk2.quantize_corpus_int8(v32)
        del v32
        mul8 = mul * sv
        for qn in FORCED_INT8_Q:
            q32 = torch.randn((qn, d), generator=g, device=DEVICE)
            q8, inv_sq = topk2.quantize_queries_int8(topk2.prepare_queries(q32, "l2"))
            bucket = topk2.bucket_for(qn, n)
            for kernel in (k for k in INT8_DESIGNS if k != "tensor_int8" or d % 16 == 0):
                rows.append({"route": "int8", "q": qn, "n": n, "d": d, "bucket": bucket,
                             **compare(kernels, q8, v8, mul8, add, bucket, inv_sq, kernel=kernel)})
                emit({"phase": "kernel_forced_int8", **rows[-1]})
        del mul, add, v8, sv, mul8
        torch.cuda.empty_cache()
    return rows


def phase_kernel_vs_plain_d768(kernels, topk2) -> list[dict]:
    """Phase 2 (c): the kernel against its plain version at 1,048,576 x 768."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(3)
    n = KERNEL_ROWS
    v32 = torch.randn((n, RES_D), generator=g, device=DEVICE)
    mul = torch.rand(n, generator=g, device=DEVICE) + 0.5
    add = torch.randn(n, generator=g, device=DEVICE)
    add[torch.rand(n, generator=g, device=DEVICE) < 0.1] = float("-inf")
    add[: 4 * 128] = float("-inf")
    v8, sv = topk2.quantize_corpus_int8(v32)
    results = []
    for qn, bucket, route in D768_SHAPES:
        q32 = torch.randn((qn, RES_D), generator=g, device=DEVICE)
        if route == "f32":
            args = (q32, v32, mul, add, bucket, None)
        else:
            q8, inv_sq = topk2.quantize_queries_int8(q32)
            args = (q8, v8, mul * sv, add, bucket, inv_sq)
        results.append({"route": route, "q": qn, "n": n, "d": RES_D, "bucket": bucket,
                        **compare(kernels, *args)})
    return results


def main_path_inputs(topk2, vectors, tags, spec, queries_np, device, n_pad: "int | None" = None):
    """The phase-1 kernel's inputs exactly as topk_two_phase builds them
    for one search of phase 3 (or of the glove100 path, whose rows the
    engine pads with masked zero rows to ``n_pad``)."""
    import torch

    name, qn, metric, k, precision, filtered, flat = spec
    corpus = torch.from_numpy(vectors).to(device)
    valid = torch.ones(corpus.shape[0], dtype=torch.bool, device=device)
    if filtered:
        valid &= torch.from_numpy(tags < 50).to(device)
    if n_pad is not None and n_pad > corpus.shape[0]:
        extra = n_pad - corpus.shape[0]
        corpus = torch.cat([corpus, corpus.new_zeros((extra, corpus.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros(extra)])
    n = corpus.shape[0]
    mul, add = topk2.prepare_aux(corpus, valid, metric)
    qp = topk2.prepare_queries(torch.from_numpy(queries_np).to(device), metric).contiguous()
    bucket = topk2.bucket_for(qn, n)
    if precision == "int8":
        v8, sv = topk2.quantize_corpus_int8(corpus)
        q8, inv_sq = topk2.quantize_queries_int8(qp)
        return (q8, v8, mul * sv, add, bucket, inv_sq)
    if precision == "bf16":
        return (qp.to(torch.bfloat16), corpus.to(torch.bfloat16), mul, add, bucket, None)
    return (qp, corpus, mul, add, bucket, None)


# -- phase 3/4/5: server, searches, oracle -------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_healthy(client, proc, timeout_s: float = 300.0) -> None:
    deadline = time.time() + timeout_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode}")
        try:
            if client.health().get("status") == "ok":
                return
        except Exception:
            if time.time() > deadline:
                raise
        client.close()
        time.sleep(0.5)


def launches(client, stats: "dict | None" = None) -> dict:
    stats = client.stats() if stats is None else stats
    return {r: int(stats.get(f"kernel.bucket_scores.{r}.launches", 0))
            for r in (*ROUTES.values(), K3_ROUTE, *(f"kernel.{k}" for k in DESIGNS))}


class Oracle:
    """Float64 exact ranking on the card, independent of the port's
    code: (distance asc, row id asc). A coarse float64 matmul pass picks
    k + 16 candidates; their distances are then recomputed elementwise
    (identical rows give identical values) and sorted by (distance, id)."""

    def __init__(self, vectors, device):
        import torch

        # widened on the card, part by part (``vectors`` may be a list of
        # row blocks): a float64 host copy would double host memory
        parts = list(vectors) if isinstance(vectors, (list, tuple)) else [vectors]
        self.v = torch.empty((sum(p.shape[0] for p in parts), parts[0].shape[1]), dtype=torch.float64,
                             device=device)
        start = 0
        for p in parts:
            self.v[start : start + p.shape[0]] = torch.from_numpy(p).to(device)
            start += p.shape[0]
        # in row blocks: a whole [N, D] float64 temporary would double the memory
        self.sq = torch.cat([(b * b).sum(dim=1) for b in self.v.split(1 << 20)])
        self.norm = self.sq.sqrt().clamp_min(1e-12)
        self.device = device

    def exact(self, q, idx, metric):
        """Elementwise float64 distances of rows ``idx`` [Q, c] to ``q``."""
        cand = self.v[idx]  # [Q, c, D]
        if metric == "l2":
            return ((cand - q[:, None, :]) ** 2).sum(-1).sqrt()
        if metric == "cosine":
            qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
            return 0.5 - 0.5 * (cand * qn[:, None, :]).sum(-1) / self.norm[idx]
        return -(cand * q[:, None, :]).sum(-1)

    def topk(self, queries_np, metric, k, mask=None, chunk=64):
        """Top-k of each query over the rows ``mask`` allows: a ``[N]``
        bool tensor for every query, or ``mask(start, stop)`` giving the
        ``[stop - start, N]`` rows of those queries. A query with fewer
        than k allowed rows gets them all, padded with (-1, +inf)."""
        import torch

        out_ids, out_d = [], []
        for s in range(0, queries_np.shape[0], chunk):
            q = torch.from_numpy(queries_np[s : s + chunk]).to(self.device, torch.float64)
            if metric == "l2":
                d = (q * q).sum(1, keepdim=True) - 2.0 * q @ self.v.T + self.sq[None, :]
            elif metric == "cosine":
                qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
                d = 0.5 - 0.5 * (qn @ self.v.T) / self.norm[None, :]
            else:
                d = -(q @ self.v.T)
            if mask is not None:
                m = mask(s, s + q.shape[0]) if callable(mask) else mask[None, :]
                d = torch.where(m, d, torch.inf)
                del m
            coarse, idx = torch.topk(d, k + 16, dim=1, largest=False)
            del d
            # candidates the mask refused (a query with fewer allowed rows
            # than the window) rank last at +inf
            fine = torch.where(torch.isfinite(coarse), self.exact(q, idx, metric), torch.inf)
            idx, order = torch.sort(idx, dim=1)
            fine = torch.gather(fine, 1, order)
            fine, order = torch.sort(fine, dim=1, stable=True)
            idx = torch.where(torch.isfinite(fine), torch.gather(idx, 1, order), -1)
            # the (k+16)-th coarse distance must clear the k-th exact one,
            # or a tied row past the window could belong in the top k (a
            # window that holds every allowed row has no row past it)
            if metric == "l2":  # the coarse pass ranks squared distances
                coarse = coarse.clamp_min(0.0).sqrt()
            margin = coarse[:, -1] - fine[:, k - 1]
            full = torch.isfinite(coarse[:, -1])
            if (full & (margin <= 1e-9 * (1.0 + fine[:, k - 1].abs()))).any():
                raise AssertionError("oracle window too narrow for the ties at k")
            out_ids.append(idx[:, :k].cpu())
            out_d.append(fine[:, :k].cpu())
        return torch.cat(out_ids).numpy(), torch.cat(out_d).numpy()


def split_result(result, qn: int, k: int):
    """[Q, k] ids and distances from a result table in query order. A query
    may return fewer than k rows (a filter and probes that leave fewer):
    its row is padded with (-1, +inf), and check_ids holds its count to
    the oracle's."""
    import numpy as np

    ids = np.array(result.column("id"))
    dist = np.array(result.column("__DISTANCE__"))
    if "__QUERY_ID__" in result.column_names:
        qid = result.column("__QUERY_ID__").to_numpy()
    else:
        qid = np.zeros(len(ids), np.int64)
    counts = np.bincount(qid, minlength=qn)
    if (np.diff(qid) < 0).any() or counts.shape[0] != qn or counts.max(initial=0) > k:
        raise AssertionError(f"result has {len(ids)} rows, expected at most {qn} x {k} in query order")
    if not np.isfinite(dist).all():
        raise AssertionError("non-finite distance in the result")
    slot = np.arange(len(ids)) - np.repeat(np.cumsum(counts) - counts, counts)
    out_ids, out_d = np.full((qn, k), -1, ids.dtype), np.full((qn, k), np.inf, dist.dtype)
    out_ids[qid, slot], out_d[qid, slot] = ids, dist
    return out_ids, out_d


def check_search(oracle, spec, queries_np, result, mask) -> dict:
    name, qn, metric, k, precision, filtered, flat = spec
    ids, dist = split_result(result, qn, k)
    return check_ids(oracle, name, metric, k, precision, queries_np, ids, dist, mask,
                     require_ties=flat is False)


def allowed(mask, ids, device) -> bool:
    """Whether every returned row passes ``mask`` (see Oracle.topk); -1
    slots are padding."""
    import numpy as np
    import torch

    if not callable(mask):
        return bool(mask.cpu().numpy()[ids[ids >= 0]].all())
    for s in range(0, ids.shape[0], 64):
        sel = torch.from_numpy(ids[s : s + 64]).to(device)
        ok = torch.gather(mask(s, s + sel.shape[0]), 1, sel.clamp_min(0)) | (sel < 0)
        if not bool(ok.all()):
            return False
    return True


def check_ids(oracle, name, metric, k, precision, queries_np, ids, dist, mask, require_ties,
              dist_tol: float = 1e-4) -> dict:
    """Hold [Q, k] result ids and distances to the float64 oracle over the
    rows ``mask`` allows: each query's row count (ids of -1 are padding,
    see split_result) equal to min(k, its allowed rows), then fp32 ids
    position by position up to near ties (exact ties in id order),
    bf16/int8 recall@k >= 0.99, every distance within dist_tol * max(1, d)."""
    import numpy as np
    import torch

    want_ids, want_d = oracle.topk(queries_np, metric, k, mask)
    real = ids >= 0
    want_n = np.isfinite(want_d).sum(axis=1)
    if (real.sum(axis=1) != want_n).any() or (real[:, 1:] & ~real[:, :-1]).any():
        bad = int((real.sum(axis=1) != want_n).sum())
        raise AssertionError(f"{name}: {bad} queries return other than min(k, allowed rows) rows")
    q = torch.from_numpy(queries_np).to(oracle.device, torch.float64)
    got_d64 = oracle.exact(q, torch.from_numpy(np.where(real, ids, 0)).to(oracle.device), metric).cpu().numpy()
    got_d64 = np.where(real, got_d64, 0.0)  # padding: 0 against 0 below
    dist_err = np.abs(np.where(real, dist, 0.0) - got_d64) / np.maximum(1.0, np.abs(got_d64))
    if dist_err.max() > dist_tol:
        raise AssertionError(f"{name}: distance off float64 by {dist_err.max()} relative")
    if mask is not None and not allowed(mask, ids, oracle.device):
        raise AssertionError(f"{name}: a row outside the filter or the probes was returned")
    ties = sum(
        len(set(row.tolist()) & {i + DUP for i in row.tolist() if 0 <= i < DUP}) for row in ids
    )
    out = {"ties_in_results": int(ties), "max_rel_dist_err": float(dist_err.max())}
    # fp32 resolves distances to about 1e-6 relative; float64 neighbours
    # closer than NEAR_TIE can come back in either order from any fp32
    # engine. Exactly equal float64 distances (the duplicate rows) must
    # come back in id order.
    want_d = np.where(real, want_d, 0.0)  # the counts agree: the same padding slots
    near_tie = NEAR_TIE * np.maximum(1.0, np.abs(want_d))
    if precision == "fp32":
        differ = ids != want_ids
        far = differ & (np.abs(got_d64 - want_d) > near_tie)
        if far.any():
            bad = int(far.any(axis=1).sum())
            raise AssertionError(f"{name}: ids differ from the float64 oracle in {bad} queries")
        tied = (got_d64[:, 1:] == got_d64[:, :-1]) & real[:, 1:]
        if (tied & (ids[:, 1:] < ids[:, :-1])).any():
            raise AssertionError(f"{name}: exactly tied rows not in id order")
        if require_ties and ties == 0:
            raise AssertionError(f"{name}: no duplicate-row ties were exercised")
        out["ids_equal_positions"] = float(1.0 - differ.mean())
        out["near_tie_swaps"] = int(differ.sum())
    else:
        last = np.maximum(want_n - 1, 0)[:, None]
        kth = np.take_along_axis(want_d, last, axis=1) + np.take_along_axis(near_tie, last, axis=1)
        hits = (got_d64 <= kth)[real]
        recall = float(hits.mean()) if hits.size else 1.0
        if recall < 0.99:
            raise AssertionError(f"{name}: recall@{k} {recall} < 0.99")
        out["recall"] = recall
    return out


def stop_server(client, proc, log, log_path: str) -> None:
    """Close the client, end the server process and print its log's tail."""
    client.close()
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.close()
    with open(log_path) as fh:
        tail = fh.read().splitlines()[-20:]
    print("server log (last lines):", *tail, sep="\n", file=sys.stderr)


def start_server(root: str, port: int, log_path: str, env_extra: "dict | None" = None):
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    log = open(log_path, "w")
    cmd = [
        sys.executable, "-m", "fenix_tpu_torch.launch", root,
        "--host", "127.0.0.1", "--port", str(port), "--device", DEVICE,
    ]
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT), log


# -- phases 3-5, the exact narrow path (glove100) ----------------------------


def put_items(client, name: str, vectors, ids_np, tags) -> float:
    """Put a table of (id, vector, tag) rows over Flight in batches of
    BATCH_ROWS; the seconds it took."""
    import pyarrow as pa

    from fenix_tpu_torch.io import ingest

    schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), vectors.shape[1]),
                        "tag": pa.int32()})

    def batches():
        for s in range(0, vectors.shape[0], BATCH_ROWS):
            e = min(s + BATCH_ROWS, vectors.shape[0])
            yield pa.record_batch([pa.array(ids_np[s:e]), ingest.numpy_to_fixed_size_list(vectors[s:e], pa.float32()),
                                   pa.array(tags[s:e])], schema=schema)

    t = time.perf_counter()
    client.make_table(name, pa.RecordBatchReader.from_batches(schema, batches()))
    return time.perf_counter() - t


def glove_rows_scanned() -> int:
    """The rows the engine scans for the glove100 table: GLOVE_ROWS padded
    to whole GLOVE_BLOCK blocks. They set bucket_for's bucket (GLOVE_ROWS
    itself is 2 times an odd number: a bucket of 2)."""
    return -(-GLOVE_ROWS // GLOVE_BLOCK) * GLOVE_BLOCK


def phase_glove_serve(client, expr, kernels, data, queries) -> dict:
    """The glove100 path on the phase-3 server: put the table, then each
    search of GLOVE_SEARCHES once cold and WARM_REPS times warm; on a card
    every call must raise its route's launch count and that of the design
    kernel_for picks at GLOVE_D (CPU tensors count nothing). The path's
    launches are the counts after it less those before."""
    import numpy as np
    import torch

    vectors, ids_np, tags = data
    put_s = put_items(client, GLOVE_TABLE, vectors, ids_np, tags)
    emit({"phase": "glove_put", "rows": vectors.shape[0], "dim": vectors.shape[1], "seconds": put_s})
    scan = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    before = launches(client)
    results, latencies = [], {}
    for spec, qnp in zip(GLOVE_SEARCHES, queries):
        name, qn, metric, k, precision, filtered, flat = spec
        kw = dict(metric=metric, maxval=k, precision=precision)
        if filtered:
            kw["filter"] = expr.field("tag") < 50
        keys = (ROUTES[precision], f"kernel.{kernels.kernel_for(scan[precision], qn, vectors.shape[1])}")
        calls = []
        for _ in range(1 + WARM_REPS):
            c0 = launches(client)
            t = time.perf_counter()
            result = client.search(qnp[0] if flat else qnp, GLOVE_TABLE, "vector", **kw)
            calls.append((time.perf_counter() - t) * 1e3)
            c1 = launches(client)
            for key in keys:
                if DEVICE == "cuda" and c1[key] <= c0[key]:
                    raise AssertionError(f"{name}: the {key} kernel count did not rise")
            if len(calls) == 1:
                results.append(result)
        latencies[name] = calls[1:]
        emit({"phase": "glove_search", "search": name, "q": qn, "k": k, "metric": metric, "precision": precision,
              "filtered": filtered, "design": keys[1], "rows_returned": results[-1].num_rows,
              "first_call_ms": calls[0], "warm_median_ms": float(np.median(calls[1:]))})
    after = launches(client)
    return {"results": results, "latencies": latencies, "launches": {k: v - before[k] for k, v in after.items()}}


def phase_glove_checks(kernels, topk2, data, queries, glove: dict) -> list[dict]:
    """After the server: each glove100 search against the float64 oracle
    by the fp32 rule whatever its scan precision (ids equal up to near
    ties, exact ties in id order; phase 2 rescores fp32-true, so distances
    within GLOVE_DIST_TOL), then the kernel against its plain version at
    each search's phase-1 inputs (the engine's padded rows), timed."""
    import torch

    vectors, ids_np, tags = data
    oracle = Oracle(vectors, DEVICE)
    mask = torch.from_numpy(tags < 50).to(DEVICE)
    for spec, qnp, result in zip(GLOVE_SEARCHES, queries, glove["results"]):
        name, qn, metric, k, precision, filtered, flat = spec
        ids, dist = split_result(result, qn, k)
        check = check_ids(oracle, name, metric, k, "fp32", qnp, ids, dist, mask if filtered else None,
                          require_ties=True, dist_tol=GLOVE_DIST_TOL)
        emit({"phase": "glove_oracle", "search": name, "precision": precision, **check})
    del oracle, mask
    rows = []
    for spec, qnp in zip(GLOVE_SEARCHES, queries):
        inputs = main_path_inputs(topk2, vectors, tags, spec, qnp, DEVICE, n_pad=glove_rows_scanned())
        want = 128 if spec[1] <= 64 else 32
        if inputs[4] != want:
            raise AssertionError(f"{spec[0]}: bucket {inputs[4]} at {inputs[1].shape[0]} rows, expected {want}")
        rows.append({"search": spec[0], "route": ROUTES[spec[4]], "q": spec[1], "n": inputs[1].shape[0],
                     "d": vectors.shape[1], "bucket": inputs[4], **compare(kernels, *inputs)})
        emit({"phase": "kernel_vs_plain_glove100", **rows[-1]})
        del inputs
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return rows


# -- phase 6: host-corpus residency (int8-resident and streaming) ------------

RES_CHUNK_ROWS = {"stream_q8": 458_752, "stream_int8_q64": 1_867_776}  # at RES_BUDGET


def residency_kernel_checks(kernels, topk2, vectors, tags, queries) -> list[dict]:
    """The kernel against its plain version at the inputs each search of
    phase 6 gives it (a stream search: its first chunk)."""
    import torch

    corpus = torch.from_numpy(vectors).to(DEVICE)
    mul, add = topk2.prepare_aux(corpus, torch.from_numpy(tags < 50).to(DEVICE), "l2")
    v8, sv = topk2.quantize_corpus_int8(corpus)
    mul8 = mul * sv
    out = []
    for name, qn, _, _, route, *_ in RES_SEARCHES:
        rows = RES_CHUNK_ROWS.get(name, RES_ROWS)
        qp = topk2.prepare_queries(torch.from_numpy(queries[qn]).to(DEVICE), "l2").contiguous()
        bucket = topk2.bucket_for(qn, rows)
        if route == "int8":
            q8, inv_sq = topk2.quantize_queries_int8(qp)
            args = (q8, v8[:rows], mul8[:rows], add[:rows], bucket, inv_sq)
        else:
            args = (qp, corpus[:rows], mul[:rows], add[:rows], bucket, None)
        out.append({"search": name, "route": route, "q": qn, "n": rows, "d": RES_D,
                    "bucket": bucket, **compare(kernels, *args)})
        emit({"phase": "kernel_vs_plain_residency_path", **out[-1]})
    del corpus, mul, add, v8, sv, mul8, args
    torch.cuda.empty_cache()
    return out


def check_rises(name: str, before: dict, after: dict, spec) -> None:
    """Each call of a phase-6 search launches its kernel and moves its
    residency counter by exactly the expected amount."""
    _, _, _, _, route, per_call, counter, rise = spec
    got = launches(None, after)[route] - launches(None, before)[route]
    if got != per_call:
        raise AssertionError(f"{name}: {got} {route} kernel launches, expected {per_call}")
    if counter is not None and after.get(counter, 0) - before.get(counter, 0) != rise:
        raise AssertionError(
            f"{name}: {counter} rose by {after.get(counter, 0) - before.get(counter, 0)}, expected {rise}"
        )


def phase_residency(kernels, topk2, Flight, expr, smi: str, kind: str, wide_data) -> dict:
    """A 4,194,304 x 768 table served past a 6 GiB budget by a second
    server: auto routes to int8 residency, then forced int8, fp32 and int8
    streaming, and dual as the same server's exact answer. Returns the
    kernel checks and the path's launch counts."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch import native
    from fenix_tpu_torch.io import ingest

    t = time.perf_counter()
    vectors, ids_np, tags = wide_data.result()  # make_data(RES_ROWS, seed=1, dim=RES_D), drawn meanwhile
    # near queries copy duplicated rows whose both copies pass tag < 50,
    # so exact ties reach every filtered top-100
    pool = np.flatnonzero((tags[:DUP] < 50) & (tags[DUP : 2 * DUP] < 50))
    queries = {q: make_queries(vectors, q, seed=100 + q, src_pool=pool) for q in (8, 64, 1024)}
    emit({"phase": "residency_data", "rows": RES_ROWS, "dim": RES_D, "budget": RES_BUDGET,
          "native_available": native.available(), "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    checks = residency_kernel_checks(kernels, topk2, vectors, tags, queries)
    emit({"phase": "kernel_vs_plain_residency_done", "seconds": time.perf_counter() - t})

    work = os.path.join(HERE, "build", "chip_smoke", f"residency-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    port = free_port()
    proc, log = start_server(os.path.join(work, "root"), port, os.path.join(work, "server.log"),
                             {"FENIX_HBM_BUDGET": str(RES_BUDGET)})
    client = Flight(host="127.0.0.1", port=port)
    results = {}
    try:
        wait_healthy(client, proc)
        if any(launches(client).values()):
            raise AssertionError("launch counts not 0 before the residency path")
        schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), RES_D),
                            "tag": pa.int32()})

        def batches():
            for s in range(0, RES_ROWS, BATCH_ROWS):
                e = min(s + BATCH_ROWS, RES_ROWS)
                yield pa.record_batch(
                    [pa.array(ids_np[s:e]), ingest.numpy_to_fixed_size_list(vectors[s:e], pa.float32()),
                     pa.array(tags[s:e])],
                    schema=schema,
                )

        t = time.perf_counter()
        client.make_table("smoke/wide", pa.RecordBatchReader.from_batches(schema, batches()))
        emit({"phase": "residency_put", "rows": RES_ROWS, "seconds": time.perf_counter() - t})

        for spec in RES_SEARCHES:
            name, qn, mode, precision = spec[:4]
            kw = dict(metric="l2", maxval=RES_K, precision=precision, residency=mode,
                      filter=expr.field("tag") < 50)
            before = client.stats()
            t = time.perf_counter()
            results[name] = client.search(queries[qn], "smoke/wide", "vector", **kw)
            first = time.perf_counter() - t
            after = client.stats()
            check_rises(name, before, after, spec)
            cold = {k: after.get(k, 0) - before.get(k, 0)
                    for k in ("cache.int8_sidecar_writes", "cache.int8_sidecar_loads",
                              "cache.mirror_rows_quantized", "cache.int8_mirror_build_seconds",
                              "cache.int8_upload_seconds", "cache.evictions", *SPLIT_KEYS)}
            warm, splits = [], []
            for _ in range(RES_WARM_REPS):
                a = client.stats()
                t = time.perf_counter()
                client.search(queries[qn], "smoke/wide", "vector", **kw)
                warm.append((time.perf_counter() - t) * 1e3)
                b = client.stats()
                check_rises(name, a, b, spec)
                splits.append({k: b.get(k, 0) - a.get(k, 0) for k in SPLIT_KEYS})
            split = {k: float(np.median([x[k] for x in splits])) for k in SPLIT_KEYS}
            if split["transfer.h2d_seconds"] > 0:
                split["h2d_GBps"] = split["transfer.h2d_bytes"] / split["transfer.h2d_seconds"] / 1e9
                split["stage_GBps"] = split["transfer.h2d_bytes"] / split["transfer.stage_seconds"] / 1e9
            emit({"phase": "residency_search", "search": name, "q": qn, "k": RES_K,
                  "residency": mode, "precision": precision, "rows_returned": results[name].num_rows,
                  "first_call_s": first, "cold": cold, "warm_median_ms": float(np.median(warm)),
                  "warm_ms": warm, "warm_split_median": split, "device": kind, "nvidia_smi": smi})
            if name == "stream_int8_q64":  # searches 1-4 kept within the budget
                st = client.stats()
                state = {k: v for k, v in st.items() if k.startswith("cache.device_")}
                emit({"phase": "residency_device_state", **state})
                if st.get("cache.device_entries.matrix", 0):
                    raise AssertionError("an fp32 device matrix exists after the host-corpus searches")
                if st["cache.device_bytes"] > RES_BUDGET:
                    raise AssertionError(f"cache.device_bytes {st['cache.device_bytes']} over the budget")
        # phase 8 (d): the no-top-k read over the host corpus
        host_read_queries = make_queries(vectors, SEL_HOST_READ[1], seed=400)
        host_read = selection_read(client, expr, SEL_HOST_READ, "smoke/wide", host_read_queries, smi, kind,
                                   "search.residency_host_nomax", pushdown=False)[0]
        final = client.stats()
        path_launches = launches(None, final)
        emit({"phase": "residency_done", "launches": path_launches,
              "device_entries": {k: v for k, v in final.items() if k.startswith("cache.device_")}})

        # -- phase 12 (e) (on the server) -------------------------------------
        t = time.perf_counter()
        mb_res = phase_batching_residency(client, Flight, port, vectors, smi, kind)
        emit({"phase": "batching_residency_done", "launches": mb_res["launches"],
              "seconds": time.perf_counter() - t})

        # -- phase 9 (on the server) ------------------------------------------
        t = time.perf_counter()
        ivfh = phase_ivf_host_serve(client, expr, vectors, tags, os.path.join(work, "root"), smi, kind)
        emit({"phase": "ivf_host_serve_done", "seconds": time.perf_counter() - t})

        # -- phase 10 (b) (on the server) -------------------------------------
        t = time.perf_counter()
        wide = phase_mutations_wide(client, expr, vectors, ids_np, tags, queries, ivfh, smi, kind)
        emit({"phase": "mutations_wide_done", "launches": wide["launches"], "seconds": time.perf_counter() - t})
    finally:
        client.close()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        with open(os.path.join(work, "server.log")) as fh:
            tail = fh.read().splitlines()[-20:]
        print("residency server log (last lines):", *tail, sep="\n", file=sys.stderr)
        if sys.exc_info()[0] is not None:  # failing: phase 15 (b) will not read the root
            shutil.rmtree(work, ignore_errors=True)

    # -- phase 15 (b): the mesh-composed residency modes on the same root ---
    try:
        t = time.perf_counter()
        live = Live(vectors, ids_np, tags)
        live.append(*wide["append"])
        mesh_res = phase_mesh_residency(os.path.join(work, "root"), live, queries, smi, kind)
        del live
        emit({"phase": "mesh_residency_done", "mesh": mesh_res["mesh"], "seconds": time.perf_counter() - t})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    stream_ids = split_result(results["stream_q8"], 8, RES_K)[0]
    if not np.array_equal(stream_ids, split_result(results["dual_q8"], 8, RES_K)[0]):
        raise AssertionError("fp32 stream ids differ from the dual ids")

    t = time.perf_counter()
    oracle = Oracle(vectors, DEVICE)
    mask = torch.from_numpy(tags < 50).to(DEVICE)
    for name, qn, *_ in RES_SEARCHES:
        graded = "int8" if name in RES_INT8_GRADED else "fp32"
        spec = (name, qn, "l2", RES_K, graded, True, False)
        emit({"phase": "residency_oracle", "search": name,
              **check_search(oracle, spec, queries[qn], results[name], mask)})
    rows = np.flatnonzero(tag_mask(tags, SEL_HOST_READ[3]))
    emit({"phase": "selection_oracle", **check_selection(
        oracle, SEL_HOST_READ[0], SEL_HOST_READ[2], host_read_queries, host_read, lambda qi: rows)})
    host_read_timings(vectors, tags, host_read_queries, smi, kind)
    emit({"phase": "residency_oracle_done", "seconds": time.perf_counter() - t})

    # -- phase 9 (after the server) -------------------------------------------
    t = time.perf_counter()
    phase_ivf_host_checks(oracle, vectors, tags, ivfh, smi, kind)
    del oracle
    torch.cuda.empty_cache()
    emit({"phase": "ivf_host_done", "seconds": time.perf_counter() - t})

    # -- phase 10 (c), the int8-resident copy ---------------------------------
    t = time.perf_counter()
    checks += mutation_kernel_checks_wide(kernels, topk2, vectors, tags, queries, wide["append"], smi, kind)
    emit({"phase": "mutation_kernels_wide_done", "seconds": time.perf_counter() - t})
    return {"checks": checks, "launches": path_launches, "mutation_launches": wide["launches"],
            "batching_launches": mb_res["launches"]}


# -- phase 7: IVF --------------------------------------------------------------


def check_counter_rises(name: str, before: dict, after: dict, rises: dict) -> None:
    """Each counter of ``rises`` moved by exactly its amount in one call."""
    for key, want in rises.items():
        got = after.get(key, 0) - before.get(key, 0)
        if got != want:
            raise AssertionError(f"{name}: {key} rose by {got}, expected {want}")


def check_route(name: str, before: dict, after: dict, route: str) -> None:
    """A phase-7 search moves its route's counter by one and the other by
    none."""
    check_counter_rises(name, before, after, {key: int(r == route) for r, key in IVF_ROUTES.items()})


def phase_ivf_serve(client, expr, vectors, root: str, smi: str, kind: str) -> dict:
    """Phase 7 on the server: build the coder and the index over Flight,
    read the cell ids back, run the four probed searches (one cold, five
    warm calls each). Returns what the checks after the server need."""
    import numpy as np

    from fenix_tpu_torch import coder
    from fenix_tpu_torch.ops import kmeans

    before = client.stats()
    c0 = launches(None, before)
    t = time.perf_counter()
    client.make_index(IVF_CODER, "smoke/items", "vector", IVF_CONFIG)
    built = client.stats()
    client_s = time.perf_counter() - t
    # the host draws of make-coder alone (the JAX package's threefry
    # permutations, ops/kmeans.draw_indices)
    t = time.perf_counter()
    kmeans.draw_indices(ROWS, 0, IVF_CONFIG["num_codebooks"], IVF_CONFIG["codebook_size"],
                        IVF_CONFIG["batch_size"], IVF_CONFIG["num_epochs"])
    emit({"phase": "ivf_build", "client_s": client_s,
          "make_coder_s": built["make-coder.seconds"] - before.get("make-coder.seconds", 0),
          "make_index_s": built["make-index.seconds"] - before.get("make-index.seconds", 0),
          "draws_s": time.perf_counter() - t,
          "lloyd_steps": IVF_CONFIG["num_epochs"] * (ROWS // IVF_CONFIG["batch_size"]),
          "config": IVF_CONFIG, "device": kind, "nvidia_smi": smi})

    t = time.perf_counter()
    coded = client.read_table("smoke/items", select=["__CODED_ID__"], coding=IVF_CODER,
                              column="vector").read_all()
    codes = np.array(coded.column(0).to_numpy())  # writable: torch takes it as is
    if codes.shape[0] != ROWS or codes.min() < 0 or codes.max() >= IVF_CELLS:
        raise AssertionError(f"coded read: {codes.shape[0]} ids in [{codes.min()}, {codes.max()}]")
    occupancy = np.bincount(codes, minlength=IVF_CELLS)
    emit({"phase": "ivf_cells", "coded_read_s": time.perf_counter() - t, "cells": IVF_CELLS,
          "rows_min": int(occupancy.min()), "rows_median": float(np.median(occupancy)),
          "rows_max": int(occupancy.max()), "empty_cells": int((occupancy == 0).sum())})
    codebooks = coder.load(root, IVF_CODER)["tensor"]

    searches = {}
    for i, (name, qn, probes, filtered, precision, route, metric) in enumerate(IVF_SEARCHES):
        queries = make_queries(vectors, qn, seed=200 + i)
        target = queries[0] if qn == 1 else queries
        kw = dict(metric=metric, maxval=IVF_K, precision=precision, coding=IVF_CODER, probes=probes,
                  filter=(expr.field("tag") < 50) if filtered else None)
        a = client.stats()
        t = time.perf_counter()
        result = client.search(target, "smoke/items", "vector", **kw)
        first = time.perf_counter() - t
        b = client.stats()
        check_route(name, a, b, route)
        cold = {k: b.get(k, 0) - a.get(k, 0) for k in IVF_SPLIT_KEYS}
        warm, splits = [], []
        for _ in range(WARM_REPS):
            a = client.stats()
            t = time.perf_counter()
            client.search(target, "smoke/items", "vector", **kw)
            warm.append((time.perf_counter() - t) * 1e3)
            b = client.stats()
            check_route(name, a, b, route)
            splits.append({k: b.get(k, 0) - a.get(k, 0) for k in IVF_SPLIT_KEYS})
        split = {k: float(np.median([x[k] for x in splits])) for k in IVF_SPLIT_KEYS}
        emit({"phase": "ivf_search", "search": name, "q": qn, "probes": probes, "k": IVF_K,
              "precision": precision, "filtered": filtered, "route": route,
              "metric_sent": metric, "rows_returned": result.num_rows, "first_call_s": first,
              "cold_split": cold, "warm_median_ms": float(np.median(warm)), "warm_ms": warm,
              "warm_split_median": split, "device": kind, "nvidia_smi": smi})
        searches[name] = (queries, result)
    after = client.stats()
    path_launches = {k: v - c0[k] for k, v in launches(None, after).items()}
    emit({"phase": "ivf_served", "launches": path_launches,
          "cache_device_bytes": after.get("cache.device_bytes"),
          "clustered_entries": after.get("cache.device_entries.clustered", 0)})
    return {"codes": codes, "codebooks": codebooks, "searches": searches, "launches": path_launches}


def ivf_assignment_check(codes, codebooks, vectors) -> dict:
    """IVF_SAMPLE_ROWS sampled rows' cell ids against the float64 argmin
    over the persisted codebooks; a different id is allowed only where the
    best two float64 distances are within 1e-5 relative and the id is one
    of them."""
    import numpy as np
    import torch

    rows = vectors.shape[0]
    sample = np.sort(np.random.default_rng(7).choice(rows, min(IVF_SAMPLE_ROWS, rows), replace=False))
    cb = torch.from_numpy(codebooks[0]).to(DEVICE, torch.float64)
    cc = (cb * cb).sum(1)
    exceptions = 0
    for s in range(0, sample.shape[0], 16_384):
        idx = sample[s : s + 16_384]
        x = torch.from_numpy(vectors[idx]).to(DEVICE, torch.float64)
        d = ((x * x).sum(1, keepdim=True) - 2.0 * x @ cb.T + cc[None, :]).clamp_min_(0.0).sqrt_()
        best = torch.topk(d, 2, dim=1, largest=False)
        got = torch.from_numpy(codes[idx]).to(DEVICE)
        wrong = got != best.indices[:, 0]
        d_got = torch.gather(d, 1, got[:, None])[:, 0]
        near = (best.values[:, 1] - best.values[:, 0] <= 1e-5 * best.values[:, 0]) & (
            d_got <= best.values[:, 1])
        if (wrong & ~near).any():
            raise AssertionError(f"{int((wrong & ~near).sum())} rows not in their float64-nearest cell")
        exceptions += int(wrong.sum())
    return {"rows": int(sample.shape[0]), "near_tie_exceptions": exceptions}


def composite_scores64(x, codebooks, cells_ids):
    """Float64 l2 composite score (sum over codebooks) of rows ``x`` [B, D]
    in cells ``cells_ids`` [B] under ``codebooks`` [n, K, D]."""
    import torch

    n, k, _ = codebooks.shape
    total = torch.zeros(x.shape[0], dtype=torch.float64)
    for j in range(n):
        digit = (cells_ids // k ** (n - 1 - j)) % k
        total += (x - codebooks[j][digit]).norm(dim=1)
    return total


def lloyd_step_check(kmeans, cells, codebooks_np, rows_np, name: str) -> dict:
    """One Lloyd step and one assignment on the card against the CPU from
    the same codebooks ``[n, K, D]`` and rows (split evenly over the
    codebooks for the step). Assignments may differ only on float64 near
    ties (1e-5 relative); the new codebooks agree within 1e-5 relative
    except the centroids such a flip touched."""
    import numpy as np
    import torch

    n, k, d = codebooks_np.shape
    batch_np = rows_np.reshape(n, -1, d)
    cb_cpu, batch_cpu = torch.from_numpy(codebooks_np), torch.from_numpy(batch_np)
    new_gpu, a_gpu = kmeans.lloyd_step_assign(cb_cpu.to(DEVICE), batch_cpu.to(DEVICE), "l2")
    new_cpu, a_cpu = kmeans.lloyd_step_assign(cb_cpu, batch_cpu, "l2")
    new_gpu, a_gpu = new_gpu.cpu(), a_gpu.cpu()
    cb64, x64 = cb_cpu.double(), batch_cpu.double()
    touched = torch.zeros((n, k), dtype=torch.bool)
    flips = 0
    for j in range(n):
        rows = torch.nonzero(a_gpu[j] != a_cpu[j])[:, 0]
        flips += int(rows.numel())
        if rows.numel():
            da = (x64[j, rows] - cb64[j, a_gpu[j, rows]]).norm(dim=1)
            db = (x64[j, rows] - cb64[j, a_cpu[j, rows]]).norm(dim=1)
            if ((da - db).abs() > 1e-5 * torch.maximum(da, db)).any():
                raise AssertionError(f"{name}: a Lloyd assignment flipped off a near tie")
            touched[j, a_gpu[j, rows]] = True
            touched[j, a_cpu[j, rows]] = True
    scale = new_cpu.abs().amax(dim=-1).clamp_min(1.0)
    err = ((new_gpu - new_cpu).abs().amax(dim=-1) / scale)[~touched]
    if err.numel() and float(err.max()) > 1e-5:
        raise AssertionError(f"{name}: Lloyd step off the CPU by {float(err.max())} relative")

    flat = torch.from_numpy(rows_np)
    c_gpu = cells.assign_cells(flat.to(DEVICE), cb_cpu.to(DEVICE), "l2").cpu()
    c_cpu = cells.assign_cells(flat, cb_cpu, "l2")
    moved = torch.nonzero(c_gpu != c_cpu)[:, 0]
    if moved.numel():
        sa = composite_scores64(flat[moved].double(), cb64, c_gpu[moved].long())
        sb = composite_scores64(flat[moved].double(), cb64, c_cpu[moved].long())
        if ((sa - sb).abs() > 1e-5 * torch.maximum(sa, sb)).any():
            raise AssertionError(f"{name}: an assignment differs off a near tie")
    return {"coder": name, "rows": int(rows_np.shape[0]), "lloyd_flips": flips,
            "centroids_touched": int(touched.sum()),
            "max_rel_err": float(err.max()) if err.numel() else 0.0,
            "assign_near_tie_differences": int(moved.numel())}


def cell_distances64(queries, codebooks, metric: str, device):
    """``[Q, k^n]`` float64 distances of the composite cells (the sum over
    the codebooks, codebook 0 the most significant digit), computed here
    apart from the port's code."""
    import numpy as np
    import torch

    q = torch.from_numpy(np.asarray(queries)).to(device, torch.float64)
    cb = torch.from_numpy(np.asarray(codebooks)).to(device, torch.float64)
    if metric == "cosine":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if metric == "l2":
        per = torch.stack([torch.cdist(q, c) for c in cb], dim=1)
    else:
        dots = torch.einsum("qd,nkd->qnk", q, cb)
        per = 0.5 - 0.5 * dots if metric == "cosine" else -dots
    out = per[:, 0]
    for j in range(1, per.shape[1]):
        out = (out[:, :, None] + per[:, j, None, :]).reshape(q.shape[0], -1)
    return out


def cells_off_float64(cells_np, queries, codebooks, metric: str) -> int:
    """The count of queries whose probe set (``cells_np``, ``[Q, P]``)
    differs from the ``P`` nearest cells in float64; an AssertionError
    where one differs outside near ties: a set holds every cell nearer
    than the first cell past the ``P`` nearest by more than CELL_TIE, and
    none farther than the ``P``-th by more than it (CELL_TIE relative past
    a distance of 1)."""
    import torch

    d = cell_distances64(queries, codebooks, metric, DEVICE)
    q, probes = cells_np.shape
    rows = torch.arange(q, device=d.device)[:, None]
    chosen = torch.zeros_like(d, dtype=torch.bool)
    chosen[rows, torch.from_numpy(cells_np.astype("int64")).to(d.device)] = True
    nearest = torch.sort(d, dim=1, stable=True)
    last = nearest.values[:, probes - 1 : probes]
    loose = d <= last + CELL_TIE * last.abs().clamp_min(1.0)
    if probes < d.shape[1]:
        past = nearest.values[:, probes : probes + 1]
        strict = d < past - CELL_TIE * past.abs().clamp_min(1.0)
    else:
        strict = loose
    off = (strict & ~chosen).any(dim=1) | (chosen & ~loose).any(dim=1)
    if bool(off.any()):
        raise AssertionError(f"{int(off.sum())} of {q} queries probe cells that a float64 ranking "
                             f"puts elsewhere, off a near tie (metric {metric}, {probes} probes)")
    top = torch.zeros_like(chosen)
    top[rows, nearest.indices[:, :probes]] = True
    return int((top != chosen).any(dim=1).sum())


def server_cells(queries, codebooks, metric: str, probes: int, site: str):
    """Each query's top ``probes`` cells by the server's own ranking
    (``executor.rank_cells`` on DEVICE), held to the float64 ranking
    (cells_off_float64); prints a ``probe_cells`` line for ``site`` with
    the count of queries that differ from it at a near tie."""
    import numpy as np

    from fenix_tpu_torch.engine import executor

    queries = np.ascontiguousarray(queries, dtype=np.float32)
    codebooks = np.asarray(codebooks, dtype=np.float32)
    cells_np, _ = executor.rank_cells(DEVICE, queries, codebooks, metric, probes)
    near = cells_off_float64(cells_np, queries, codebooks, metric)
    emit({"phase": "probe_cells", "site": site, "metric": metric, "queries": int(cells_np.shape[0]),
          "probes": int(cells_np.shape[1]), "probe_sets_off_float64": near})
    return cells_np


def probe_mask(codes_dev, cells_np, tags_dev, n_cells: "int | None" = None):
    """``mask(start, stop)`` for Oracle.topk: the rows whose cell (of
    ``n_cells``) is among those queries' probe cells (and, given
    ``tags_dev``, with tag < 50)."""
    import torch

    def mask(start, stop):
        c = cells_np[start:stop]
        table = torch.zeros((c.shape[0], n_cells or IVF_CELLS), dtype=torch.bool, device=codes_dev.device)
        table[torch.arange(c.shape[0], device=codes_dev.device)[:, None],
              torch.from_numpy(c.astype("int64")).to(codes_dev.device)] = True
        m = table[:, codes_dev]
        return m & (tags_dev < 50)[None, :] if tags_dev is not None else m

    return mask


def ivf_oracle_checks(oracle, ivf: dict, tags) -> list[dict]:
    """Each phase-7 search against the float64 oracle over its probe
    cells (as the server ranks them, server_cells), on every query
    of a batch up to IVF_CHECKED and IVF_CHECKED evenly spaced queries of
    a larger one; and the count of queries whose probe set differs from a
    float64 ranking of the cells at a near tie (cells_off_float64)."""
    import numpy as np
    import torch

    codes_dev = torch.from_numpy(ivf["codes"]).to(oracle.device)
    tags_dev = torch.from_numpy(tags).to(oracle.device)
    cb = ivf["codebooks"]
    out = []
    for name, qn, probes, filtered, precision, route, _ in IVF_SEARCHES:
        queries, result = ivf["searches"][name]
        ids, dist = split_result(result, qn, IVF_K)
        sel = np.arange(qn) if qn <= IVF_CHECKED else np.linspace(0, qn - 1, IVF_CHECKED).astype(np.int64)
        probe_cells = server_cells(queries, cb, "l2", probes, f"ivf_oracle.{name}")
        boundary = cells_off_float64(probe_cells, queries, cb, "l2")
        check = check_ids(oracle, name, "l2", IVF_K, precision, np.ascontiguousarray(queries[sel]),
                          ids[sel], dist[sel], probe_mask(codes_dev, probe_cells[sel],
                                                          tags_dev if filtered else None),
                          require_ties=False)
        out.append({"search": name, "route": route, "queries_checked": int(sel.shape[0]),
                    "probe_sets_off_float64": int(boundary), **check})
        emit({"phase": "ivf_oracle", **out[-1]})
    return out


def ivf_timings(kernels, topk2, kmeans, cells, executor, vectors, tags, ivf, smi, kind) -> dict:
    """The IVF hot ops timed alone on the card (CUDA events): the masked
    scan at the shape of IVF_TIMED's scan search (Q=1024, 64 probes)
    beside the unprobed phase-1 kernel and the bare product at the same
    Q, N and D; the clustered gather and rescore at its clustered search's
    (Q=8, 64 probes, filtered; its ids held to the server's); one Lloyd
    step and one assignment block of the trained coder."""
    import numpy as np
    import torch

    corpus = torch.from_numpy(vectors).to(DEVICE)
    codes = ivf["codes"]
    codebooks = torch.from_numpy(ivf["codebooks"]).to(DEVICE)
    out = {}

    probes = {spec[0]: spec[2] for spec in IVF_SEARCHES}
    queries, _ = ivf["searches"][IVF_TIMED["masked_scan"]]
    qn, p = queries.shape[0], probes[IVF_TIMED["masked_scan"]]
    mul, add = topk2.prepare_aux(corpus, None, "l2")
    coded = torch.from_numpy(codes.astype(np.int32)).to(DEVICE)
    probe = torch.from_numpy(server_cells(queries, ivf["codebooks"], "l2", p, "ivf_timings.masked_scan")).to(DEVICE)
    q = torch.from_numpy(queries).to(DEVICE)
    qp = topk2.prepare_queries(q, "l2").contiguous()
    bucket = topk2.bucket_for(qn, ROWS)
    probed = topk2.bucket_scores_scan_probed(qp, corpus, mul, add, coded, probe, bucket)
    unprobed = kernels.bucket_scores(qp, corpus, mul, add, bucket)
    # a probed bucket's maximum is over fewer rows: never above the unprobed one
    if bool((probed > unprobed + 1e-3 * unprobed.abs().clamp_min(1.0)).any()):
        raise AssertionError("a probed bucket maximum exceeds the unprobed one")
    del probed, unprobed
    b = bound("f32", qn, ROWS, D, bucket)
    out["masked_scan"] = {
        "shape": {"q": qn, "n": ROWS, "d": D, "bucket": bucket, "probes": p, "cells": IVF_CELLS},
        "ms": time_ms(lambda: topk2.bucket_scores_scan_probed(qp, corpus, mul, add, coded, probe, bucket),
                      TIMING_REPS),
        "unprobed_kernel_ms": time_ms(lambda: kernels.bucket_scores(qp, corpus, mul, add, bucket),
                                      TIMING_REPS),
        "unprobed_kernel": kernels.kernel_for(torch.float32, qn, D),
        "product_ms": time_ms(library_fn(qp, corpus), TIMING_REPS),
        "search_ms": time_ms(lambda: topk2.topk_two_phase_probed(
            corpus, q, mul, add, coded, probe, k=16, metric="l2"), 1),
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
    }
    out["masked_scan"]["ratio_to_kernel"] = out["masked_scan"]["ms"] / out["masked_scan"]["unprobed_kernel_ms"]
    del mul, add, probe, q, qp

    queries, result = ivf["searches"][IVF_TIMED["clustered"]]
    p = probes[IVF_TIMED["clustered"]]
    perm = np.argsort(codes, kind="stable")
    offsets = np.searchsorted(codes[perm], np.arange(IVF_CELLS + 1))
    perm_dev = torch.from_numpy(perm).to(DEVICE)
    corpus_s = corpus[perm_dev]
    valid_s = torch.from_numpy(tags[perm] < 50).to(DEVICE)
    mul_s, add_s = topk2.prepare_aux(corpus_s, valid_s, "l2")
    coded_s = coded[perm_dev]
    orig = perm_dev.to(torch.int32)
    probe = server_cells(queries, ivf["codebooks"], "l2", p, "ivf_timings.clustered")
    bucket = topk2.bucket_for(queries.shape[0], ROWS)
    lists = executor._ivf_bucket_lists(probe, offsets, bucket, ROWS // bucket)
    q = torch.from_numpy(queries).to(DEVICE)
    args = (corpus_s, q, mul_s, add_s, coded_s, orig, torch.from_numpy(probe).to(DEVICE),
            torch.from_numpy(lists).to(DEVICE))
    _, got = topk2.topk_ivf_clustered(*args, k=16, metric="l2")
    served = split_result(result, queries.shape[0], IVF_K)[0]
    if not np.array_equal(got[:, :IVF_K].cpu().numpy(), served):
        raise AssertionError("the clustered gather alone and the server disagree")
    out["clustered"] = {
        "shape": {"q": queries.shape[0], "n": ROWS, "d": D, "bucket": bucket, "probes": p,
                  "buckets_per_query": int(lists.shape[1]), "filtered": True},
        "ms": time_ms(lambda: topk2.topk_ivf_clustered(*args, k=16, metric="l2"), TIMING_REPS),
    }
    del corpus_s, mul_s, add_s, coded_s, orig, args, valid_s, perm_dev

    g = torch.Generator(device="cpu").manual_seed(8)
    rows = torch.randint(0, ROWS, (IVF_CONFIG["batch_size"],), generator=g).to(DEVICE)
    batch = corpus[rows]
    out["lloyd_step"] = {
        "shape": {"k": IVF_CELLS, "batch": IVF_CONFIG["batch_size"], "d": D},
        "ms": time_ms(lambda: kmeans.lloyd_step(codebooks, batch[None], "l2"), TIMING_REPS),
        "calls_per_make_coder": IVF_CONFIG["num_epochs"] * (ROWS // IVF_CONFIG["batch_size"]),
    }
    out["assign_block"] = {
        "shape": {"k": IVF_CELLS, "rows": batch.shape[0], "d": D},
        "ms": time_ms(lambda: cells.assign_cells(batch, codebooks, "l2"), TIMING_REPS),
        "calls_per_make_index": -(-ROWS // batch.shape[0]),
    }
    del corpus, coded, batch
    torch.cuda.empty_cache()
    for name, row in out.items():
        emit({"phase": "ivf_timing", "op": name, **row, "device": kind, "nvidia_smi": smi})
    return out


def phase_ivf_checks(kernels, topk2, oracle, vectors, tags, ivf, smi, kind) -> dict:
    """Phase 7 after the server: the assignment, device-step and oracle
    checks, then the timings."""
    import numpy as np
    import torch

    from fenix_tpu_torch.engine import executor
    from fenix_tpu_torch.ops import cells, kmeans

    t = time.perf_counter()
    assign = ivf_assignment_check(ivf["codes"], ivf["codebooks"], vectors)
    emit({"phase": "ivf_assignment", **assign, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    rng = np.random.default_rng(9)
    rows_np = vectors[np.sort(rng.choice(ROWS, IVF_STEP_ROWS, replace=False))]
    steps = [lloyd_step_check(kmeans, cells, ivf["codebooks"], rows_np, IVF_CODER)]
    corpus = torch.from_numpy(vectors[: 1 << 20]).to(DEVICE)
    composite = kmeans.train(corpus, 5, num_codebooks=2, codebook_size=64, batch_size=32_768,
                             num_epochs=1, metric="l2").cpu().numpy()
    del corpus
    steps.append(lloyd_step_check(kmeans, cells, composite, rows_np, "composite_2x64"))
    for r in steps:
        emit({"phase": "ivf_device_step", **r})
    emit({"phase": "ivf_device_step_done", "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    checks = ivf_oracle_checks(oracle, ivf, tags)
    emit({"phase": "ivf_oracle_done", "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    timings = ivf_timings(kernels, topk2, kmeans, cells, executor, vectors, tags, ivf, smi, kind)
    emit({"phase": "ivf_timings_done", "seconds": time.perf_counter() - t})
    return {"assignment": assign, "device_step": steps, "oracle": checks, "timings": timings}


# -- phase 8: selection -------------------------------------------------------


def tag_filter(expr, pred, divide: bool = False):
    """The filter of a phase-8 predicate ``(op, value)`` on the tag column;
    with ``divide`` the same rows through ``(tag / 1)``, which keeps it on
    the host route."""
    if pred is None:
        return None
    col = expr.field("tag") / 1 if divide else expr.field("tag")
    op, value = pred
    return col == value if op == "==" else col < value


def tag_mask(tags, pred):
    """Host bool mask of a phase-8 predicate over ``tags``."""
    import numpy as np

    if pred is None:
        return np.ones(tags.shape[0], bool)
    op, value = pred
    return tags == value if op == "==" else tags < value


def launch_rises(keys, per_call: int) -> dict:
    """The launch counters of ``keys`` each rising by ``per_call``: on a
    card only; CPU tensors take the plain version and count nothing."""
    return {f"kernel.bucket_scores.{k}.launches": per_call if DEVICE == "cuda" else 0 for k in keys}


def selection_pushdown(client, expr, kernels, vectors, tags, specs: dict, smi: str, kind: str) -> list[dict]:
    """Phase 8 (a): each search of SEL_PUSHDOWN on the device filter route
    and then on the host route (one cold and WARM_REPS warm calls each),
    every call moving its route's counter by one, the other's by none, and
    its kernel's launches by one. Both routes must return the same ids,
    and the device route the ids the earlier phase got."""
    import numpy as np
    import torch

    scan_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    out = []
    for name, earlier in SEL_PUSHDOWN:
        queries, kw, before_ids = specs[earlier]
        qn = queries.shape[0] if queries.ndim == 2 else 1
        if "coding" in kw:
            keys = ()
        else:
            keys = (ROUTES[kw["precision"]],
                    f"kernel.{kernels.kernel_for(scan_dtypes[kw['precision']], qn, D)}")
        row = {"phase": "selection_pushdown", "search": name, "reruns": earlier, "q": qn,
               "device": kind, "nvidia_smi": smi}
        ids = {}
        for route, counter in SEL_ROUTES.items():
            filt = tag_filter(expr, ("<", 50), divide=route == "host")
            rises = {**{c: int(c == counter) for c in SEL_ROUTES.values()}, **launch_rises(keys, 1)}
            warm, splits = [], []
            for rep in range(1 + WARM_REPS):
                a = client.stats()
                t = time.perf_counter()
                result = client.search(queries, "smoke/items", "vector", **kw, filter=filt)
                took = (time.perf_counter() - t) * 1e3
                b = client.stats()
                check_counter_rises(f"{name} ({route})", a, b, rises)
                if rep == 0:
                    ids[route] = np.asarray(result.column("id"))
                    row[f"{route}_first_call_ms"] = took
                else:
                    warm.append(took)
                    splits.append({k: b.get(k, 0) - a.get(k, 0) for k in SEL_SPLIT_KEYS})
            row[f"{route}_warm_median_ms"] = float(np.median(warm))
            row[f"{route}_warm_ms"] = warm
            row[f"{route}_warm_split_median"] = {k: float(np.median([x[k] for x in splits]))
                                                 for k in SEL_SPLIT_KEYS}
        if not np.array_equal(ids["device"], ids["host"]):
            raise AssertionError(f"{name}: the device and host filter routes return different ids")
        if before_ids is not None and not np.array_equal(ids["device"], before_ids):
            raise AssertionError(f"{name}: ids differ from the earlier phase's")
        row["rows_returned"] = int(ids["device"].shape[0])
        row["cache_device_mask_builds"] = client.stats()["cache.device_mask_builds"]
        emit(row)
        out.append(row)
    return out


def selection_read(client, expr, spec, table_name: str, queries, smi: str, kind: str, counter: str,
                   pushdown: bool, coding: str = IVF_CODER) -> tuple:
    """One no-top-k read of phase 8 (b) or (d): a cold call and
    SEL_READ_REPS warm ones, each moving ``counter`` by one and no kernel
    launch; a filter moves ``filter.device_pushdown`` by one where it runs
    on the card (``pushdown``, the device reads) and no filter counter on
    the host-corpus read, which takes the host's memoized mask. Returns
    the first result and its printed row."""
    import numpy as np

    name, qn, metric, pred, probes = spec
    kw = dict(metric=metric, maxval=None, select=["id"], filter=tag_filter(expr, pred))
    if probes is not None:
        kw.update(coding=coding, probes=probes)
    target = queries[0] if qn == 1 else queries
    rises = {counter: 1, "filter.device_pushdown": int(pred is not None and pushdown),
             "filter.host_upload": 0, **launch_rises(ALL_LAUNCH_KEYS, 0)}
    client_ms, server_ms = [], []
    result = None
    for _ in range(1 + SEL_READ_REPS):
        a = client.stats()
        t = time.perf_counter()
        got = client.search(target, table_name, "vector", **kw)
        client_ms.append((time.perf_counter() - t) * 1e3)
        b = client.stats()
        check_counter_rises(name, a, b, rises)
        server_ms.append((b["search.seconds"] - a.get("search.seconds", 0)) * 1e3)
        result = got if result is None else result
    row = {"phase": "selection_read", "search": name, "q": qn, "metric": metric, "filter": pred,
           "probes": probes, "rows_returned": result.num_rows, "first_client_ms": client_ms[0],
           "first_server_ms": server_ms[0], "warm_client_median_ms": float(np.median(client_ms[1:])),
           "warm_server_median_ms": float(np.median(server_ms[1:])),
           "client_ms": client_ms, "server_ms": server_ms, "device": kind, "nvidia_smi": smi}
    emit(row)
    return result, row


def rerun_specs(queries, results, ivf: dict) -> dict:
    """The earlier searches phase 8 (a) reruns: per name, the target, the
    search's options without its filter, and its ids where it was
    filtered with tag < 50 (None otherwise)."""
    import numpy as np

    specs = {}
    for spec, qnp, result in zip(SEARCHES, queries, results):
        name, qn, metric, k, precision, filtered, flat = spec
        specs[name] = (qnp[0] if flat else qnp, dict(metric=metric, maxval=k, precision=precision),
                       np.asarray(result.column("id")) if filtered else None)
    for name, qn, probes, filtered, precision, _, metric in IVF_SEARCHES:
        qnp, result = ivf["searches"][name]
        kw = dict(metric=metric, maxval=IVF_K, precision=precision, coding=IVF_CODER, probes=probes)
        specs[name] = (qnp[0] if qn == 1 else qnp, kw, np.asarray(result.column("id")) if filtered else None)
    return specs


def phase_selection_serve(client, expr, kernels, vectors, tags, specs: dict, smi: str, kind: str) -> dict:
    """Phase 8 on the phase-3 server: (a) the filter routes, (b) the
    device no-top-k reads. Returns what the oracle after the server needs
    and the path's kernel launches."""
    before = launches(client)
    pushdown = selection_pushdown(client, expr, kernels, vectors, tags, specs, smi, kind)
    reads = {}
    for i, spec in enumerate(SEL_READS):
        queries = make_queries(vectors, spec[1], seed=300 + i)
        counter = "search.nomax_full" if spec[3] is None and spec[4] is None else "search.nomax_selected"
        reads[spec[0]] = (spec, queries, selection_read(client, expr, spec, "smoke/items", queries, smi,
                                                        kind, counter, pushdown=True)[0])
    after = launches(client)
    return {"pushdown": pushdown, "reads": reads,
            "launches": {k: v - before[k] for k, v in after.items()}}


def check_selection(oracle, name: str, metric: str, queries, result, want_rows) -> dict:
    """A no-top-k result held to its oracle: per query, exactly the rows
    ``want_rows(qi)`` (ascending row numbers) in table order, queries in
    order; every distance within 1e-4 * max(1, d) of float64 (computed on
    the oracle's device, SEL_ORACLE_ROWS rows at a time)."""
    import numpy as np
    import torch

    ids = np.asarray(result.column("id"))
    dist = np.asarray(result.column("__DISTANCE__"))
    qn = queries.shape[0]
    if "__QUERY_ID__" in result.column_names:
        qid = result.column("__QUERY_ID__").to_numpy()
    elif qn == 1:
        qid = np.zeros(ids.shape[0], np.int64)
    else:
        raise AssertionError(f"{name}: a batch result without __QUERY_ID__")
    if (np.diff(qid) < 0).any():
        raise AssertionError(f"{name}: queries out of order")
    bounds = np.searchsorted(qid, np.arange(qn + 1))
    worst = 0.0
    for qi in range(qn):
        got = ids[bounds[qi] : bounds[qi + 1]]
        want = want_rows(qi)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: query {qi} returned {got.shape[0]} rows, not the "
                                 f"{want.shape[0]} selected rows in table order")
        q = torch.from_numpy(queries[qi : qi + 1]).to(oracle.device, torch.float64)
        d = dist[bounds[qi] : bounds[qi + 1]]
        for s in range(0, got.shape[0], SEL_ORACLE_ROWS):
            idx = torch.from_numpy(got[s : s + SEL_ORACLE_ROWS]).to(oracle.device)
            d64 = oracle.exact(q, idx[None, :], metric)[0].cpu().numpy()
            err = np.abs(d[s : s + SEL_ORACLE_ROWS] - d64) / np.maximum(1.0, np.abs(d64))
            worst = max(worst, float(err.max(initial=0.0)))
    if worst > 1e-4:
        raise AssertionError(f"{name}: distance off float64 by {worst} relative")
    return {"search": name, "rows": int(ids.shape[0]), "rows_per_query": int(ids.shape[0] // max(qn, 1)),
            "max_rel_dist_err": worst}


def phase_selection_checks(oracle, tags, ivf: dict, sel: dict) -> list[dict]:
    """Phase 8 (c): each device read against its oracle; the probed read's
    rows are those of the server's probe cells (server_cells over
    the persisted codebooks) that pass the filter, through probe_mask."""
    import numpy as np
    import torch

    out = []
    for name, (spec, queries, result) in sel["reads"].items():
        _, qn, metric, pred, probes = spec
        host_mask = tag_mask(tags, pred)
        if probes is None:
            rows = np.flatnonzero(host_mask)
            want = lambda qi, rows=rows: rows  # noqa: E731
        else:
            codes_dev = torch.from_numpy(ivf["codes"]).to(oracle.device)
            probe = server_cells(queries, ivf["codebooks"], "l2", probes, f"selection.{name}")
            mask = probe_mask(codes_dev, probe, torch.from_numpy(tags).to(oracle.device))
            want = lambda qi, mask=mask: np.flatnonzero(mask(qi, qi + 1)[0].cpu().numpy())  # noqa: E731
        out.append(check_selection(oracle, name, metric, queries, result, want))
        emit({"phase": "selection_oracle", **out[-1]})
    return out


def selection_timings(vectors, tags, ivf: dict, smi: str, kind: str) -> dict:
    """The hot ops of phase 8 timed alone on the card (CUDA events), at
    the phase's shapes: the device mask build of tag < 50 over the int32
    column, its permutation into the clustered order, the two count passes
    and the compaction of one chunk of the Q=8 cosine tag == 7 read."""
    import numpy as np
    import torch

    from fenix_tpu_torch import expr
    from fenix_tpu_torch.engine import executor
    from fenix_tpu_torch.ops import select as select_ops

    def timed(shape: dict, per_request: str, fn) -> dict:
        return {"shape": shape, "launches_per_request": per_request, "ms": time_ms(fn, TIMING_REPS)}

    n = vectors.shape[0]
    out = {}
    tag_dev = torch.from_numpy(tags).to(DEVICE)
    skeleton, literals = (expr.field("tag") < 50).split_literals()
    slots = [torch.tensor(v) for v in literals]
    out["mask_build"] = timed({"rows": n, "column": "int32"}, "1 per (predicate, revision)",
                              lambda: skeleton.device_mask({"tag": tag_dev}, slots))
    mask = tag_dev < 50
    perm = torch.from_numpy(np.argsort(ivf["codes"], kind="stable")).to(DEVICE)
    out["permutation_take"] = timed({"rows": n}, "1 per filtered clustered search", lambda: mask[perm])
    del perm

    _, qn, metric, pred, _ = SEL_READS[0]
    chunk = select_ops.chunk_for(n, qn, executor._NOMAX_BLOCK)
    eq = tag_dev == pred[1]
    out["count_pass_mask"] = timed({"rows": n, "chunk": chunk}, "1 per filtered read",
                                   lambda: select_ops.count_selected_mask(eq, n, chunk=chunk))
    corpus = torch.from_numpy(vectors).to(DEVICE)
    queries = torch.from_numpy(make_queries(vectors, qn, seed=300)).to(DEVICE)
    width = executor._canonical_k(int(select_ops.count_selected_mask(eq, n, chunk=chunk).max()))
    out["compact_chunk"] = timed(
        {"q": qn, "chunk": chunk, "d": D, "width": width, "metric": metric},
        f"1 per chunk with matches ({n // chunk} here)",
        lambda: select_ops.compact_chunk(corpus, queries, eq, None, None, 0, n, metric=metric,
                                         chunk=chunk, width=width))

    _, qn, metric, pred, probes = SEL_READS[1]
    probe = server_cells(make_queries(vectors, qn, seed=301), ivf["codebooks"], "l2", probes, "selection_timings")
    cells_sorted = torch.from_numpy(np.sort(probe, axis=1).astype(np.int32)).to(DEVICE)
    coded = torch.from_numpy(ivf["codes"].astype(np.int32)).to(DEVICE)
    chunk = select_ops.chunk_for(n, qn, executor._NOMAX_BLOCK)
    out["count_pass_probed"] = timed(
        {"q": qn, "rows": n, "probes": probes, "chunk": chunk}, "1 per probed read",
        lambda: select_ops.count_selected_probed(mask, coded, cells_sorted, n, chunk=chunk))
    del corpus, coded, tag_dev
    torch.cuda.empty_cache()
    for name, row in out.items():
        emit({"phase": "selection_timing", "op": name, **row, "device": kind, "nvidia_smi": smi})
    return out


def host_ms(fn, reps: int = TIMING_REPS) -> float:
    """Host clock, mean of ``reps`` calls after a warm-up."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3


def host_read_timings(vectors, tags, queries, smi: str, kind: str) -> dict:
    """Phase 8 (d)'s host work timed alone (host clock, mean of
    TIMING_REPS after a warm-up): native.row_score of one query over the
    selected rows, the primitive of a cosine or dot host read, and the
    l2 distances of every query (residency._host_l2)."""
    import numpy as np

    from fenix_tpu_torch import native
    from fenix_tpu_torch.engine import residency

    sel = np.flatnonzero(tag_mask(tags, SEL_HOST_READ[3]))
    ones, zeros = np.ones(vectors.shape[0], np.float32), np.zeros(vectors.shape[0], np.float32)
    out = {
        "host_row_score": {"shape": {"rows": int(sel.size), "d": vectors.shape[1]},
                           "launches_per_request": "1 per query of a cosine or dot host read",
                           "ms": host_ms(lambda: native.row_score(vectors, sel, queries[0], ones, zeros))},
        "host_l2_distances": {"shape": {"q": queries.shape[0], "rows": int(sel.size), "d": vectors.shape[1]},
                              "launches_per_request": "1 per l2 host read",
                              "ms": host_ms(lambda: residency._host_l2(vectors, sel, queries))},
    }
    for name, row in out.items():
        emit({"phase": "selection_timing", "op": name, **row, "clock": "host", "device": kind,
              "nvidia_smi": smi})
    return out


# -- phase 9: IVF past the budget -----------------------------------------------


def phase_ivf_host_serve(client, expr, vectors, tags, root: str, smi: str, kind: str) -> dict:
    """Phase 9 on the phase-6 server (past its budget): make_index of the
    IVF coder must train by streaming the host corpus in fp32 transport and
    assign on the host; the coded read gives the cell occupancy; the two
    probed searches run on the host (search.residency_probed_host, no
    kernel launch; the first call writes the IVF sidecar), one cold and
    RES_WARM_REPS warm calls each; then the probed no-top-k read. Returns what
    the checks after the server need."""
    import numpy as np

    from fenix_tpu_torch import coder

    rows = vectors.shape[0]
    no_launch = launch_rises(ALL_LAUNCH_KEYS, 0)
    steps = IVFH_CONFIG["num_epochs"] * (rows // (IVFH_CONFIG["num_codebooks"] * IVFH_CONFIG["batch_size"]))
    before = client.stats()
    t = time.perf_counter()
    client.make_index(IVFH_CODER, "smoke/wide", "vector", IVFH_CONFIG)
    client_s = time.perf_counter() - t
    built = client.stats()
    check_counter_rises("ivf_host_build", before, built, {
        "train.stream_fp32": 1, "train.stream_steps": steps, "index.host_assigns": 1, **no_launch})
    emit({"phase": "ivf_host_build", "client_s": client_s,
          "make_coder_s": built["make-coder.seconds"] - before.get("make-coder.seconds", 0),
          "make_index_s": built["make-index.seconds"] - before.get("make-index.seconds", 0),
          "lloyd_steps": steps, "train_h2d_bytes": built.get("transfer.h2d_bytes", 0)
          - before.get("transfer.h2d_bytes", 0), "config": IVFH_CONFIG, "device": kind, "nvidia_smi": smi})

    coded = client.read_table("smoke/wide", select=["__CODED_ID__"], coding=IVFH_CODER, column="vector").read_all()
    codes = np.array(coded.column(0).to_numpy())
    if codes.shape[0] != rows or codes.min() < 0 or codes.max() >= IVFH_CELLS:
        raise AssertionError(f"coded read: {codes.shape[0]} ids in [{codes.min()}, {codes.max()}]")
    occupancy = np.bincount(codes, minlength=IVFH_CELLS)
    emit({"phase": "ivf_host_cells", "cells": IVFH_CELLS, "rows_min": int(occupancy.min()),
          "rows_median": float(np.median(occupancy)), "rows_max": int(occupancy.max()),
          "empty_cells": int((occupancy == 0).sum())})

    pool = np.flatnonzero(tags[:DUP] < 50)
    searches = {}
    for i, (name, qn, probes, filtered) in enumerate(IVFH_SEARCHES):
        queries = make_queries(vectors, qn, seed=500 + i, src_pool=pool)
        target = queries[0] if qn == 1 else queries
        kw = dict(metric="l2", maxval=IVFH_K, coding=IVFH_CODER, probes=probes,
                  filter=(expr.field("tag") < 50) if filtered else None)
        calls, server, splits, result = [], [], [], None
        for rep in range(1 + RES_WARM_REPS):
            a = client.stats()
            t = time.perf_counter()
            got = client.search(target, "smoke/wide", "vector", **kw)
            calls.append((time.perf_counter() - t) * 1e3)
            b = client.stats()
            check_counter_rises(name, a, b, {"search.residency_probed_host": 1,
                                             "cache.ivf_sidecar_writes": int(i == 0 and rep == 0), **no_launch})
            server.append((b["search.seconds"] - a.get("search.seconds", 0)) * 1e3)
            splits.append({k: (b.get(k, 0) - a.get(k, 0)) * 1e3 for k in IVFH_SPLIT_KEYS})
            result = got if result is None else result
        emit({"phase": "ivf_host_search", "search": name, "q": qn, "probes": probes, "k": IVFH_K,
              "filtered": filtered, "rows_returned": result.num_rows, "first_client_ms": calls[0],
              "first_server_ms": server[0], "warm_client_median_ms": float(np.median(calls[1:])),
              "warm_server_median_ms": float(np.median(server[1:])), "client_ms": calls, "server_ms": server,
              "first_split_ms": splits[0],
              "warm_split_median_ms": {k: float(np.median([x[k] for x in splits[1:]])) for k in IVFH_SPLIT_KEYS},
              "device": kind, "nvidia_smi": smi})
        searches[name] = (queries, kw, result)
    read_queries = make_queries(vectors, IVFH_READ[1], seed=510)
    read = selection_read(client, expr, IVFH_READ, "smoke/wide", read_queries, smi, kind,
                          "search.residency_host_nomax", pushdown=False, coding=IVFH_CODER)[0]
    return {"codes": codes, "codebooks": coder.load(root, IVFH_CODER)["tensor"], "searches": searches,
            "read": (read_queries, read)}


def phase_ivf_host_checks(oracle, vectors, tags, ivfh: dict, smi: str, kind: str) -> dict:
    """Phase 9 after the server: IVF_SAMPLE_ROWS rows' cell ids against the
    float64 argmin; one Lloyd step of a streamed chunk's shape on the card
    against the CPU from the trained codebooks; each probed search against
    the float64 oracle over its probe cells' rows (server_cells)
    that pass the filter: recall@100 >= 0.99, every distance within
    1e-4 * max(1, d); the probed read's rows exactly the probe cells' rows
    with tag == 7, in table order; then the host hot ops timed alone."""
    import numpy as np
    import torch

    from fenix_tpu_torch import native
    from fenix_tpu_torch.engine import residency
    from fenix_tpu_torch.ops import cells, kmeans, topk2

    codes, codebooks = ivfh["codes"], ivfh["codebooks"]
    t = time.perf_counter()
    out = {"assignment": ivf_assignment_check(codes, codebooks, vectors)}
    emit({"phase": "ivf_host_assignment", **out["assignment"], "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    rng = np.random.default_rng(11)
    rows_np = vectors[np.sort(rng.choice(vectors.shape[0], min(IVFH_STEP_ROWS, vectors.shape[0]), replace=False))]
    out["device_step"] = lloyd_step_check(kmeans, cells, codebooks, rows_np, IVFH_CODER)
    emit({"phase": "ivf_host_device_step", **out["device_step"], "seconds": time.perf_counter() - t})

    codes_dev = torch.from_numpy(codes).to(oracle.device)
    tags_dev = torch.from_numpy(tags).to(oracle.device)
    out["oracle"] = []
    for name, qn, probes, filtered in IVFH_SEARCHES:
        queries, _, result = ivfh["searches"][name]
        ids, dist = split_result(result, qn, IVFH_K)
        probe = server_cells(queries, codebooks, "l2", probes, f"ivf_host.{name}")
        mask = probe_mask(codes_dev, probe, tags_dev if filtered else None, IVFH_CELLS)
        check = check_ids(oracle, name, "l2", IVFH_K, "int8", queries, ids, dist, mask, require_ties=False)
        out["oracle"].append({"search": name, **check})
        emit({"phase": "ivf_host_oracle", **out["oracle"][-1]})
    read_queries, read = ivfh["read"]
    name, _, metric, pred, probes = IVFH_READ
    probe = server_cells(read_queries, codebooks, "l2", probes, f"ivf_host.{name}")
    want = lambda qi: np.flatnonzero(np.isin(codes, probe[qi]) & tag_mask(tags, pred))  # noqa: E731
    out["read"] = check_selection(oracle, name, metric, read_queries, read, want)
    emit({"phase": "ivf_host_oracle", **out["read"]})

    # the host hot ops alone: the probed int8 scan of one Q=8 p64 query
    # (native.row_score over its probe cells' rows, held contiguous as the
    # cell-sorted layout holds them) and one host assignment block
    queries = ivfh["searches"][IVFH_SEARCHES[-1][0]][0]
    probe = server_cells(queries[:1], codebooks, "l2", IVFH_SEARCHES[-1][2], "ivf_host_timings")[0]
    sel = np.flatnonzero(np.isin(codes, probe))
    c8, sv = topk2.quantize_rows_int8_np(vectors[sel])
    pos = np.arange(sel.size)
    mul, add = sv, -np.einsum("nd,nd->n", vectors[sel], vectors[sel])
    qp = 2.0 * queries[0]
    block = vectors[: min(IVFH_STEP_ROWS // 4, vectors.shape[0])]
    out["timings"] = {
        "host_probed_score": {"shape": {"rows": int(sel.size), "d": vectors.shape[1], "probes": int(probe.size)},
                              "per_request": "1 per query of a probed host search",
                              "ms": host_ms(lambda: native.row_score(c8, pos, qp, mul, add))},
        "host_assign_block": {"shape": {"rows": int(block.shape[0]), "cells": IVFH_CELLS, "d": vectors.shape[1]},
                              "per_request": f"{-(-vectors.shape[0] // block.shape[0])} per make-index",
                              "ms": host_ms(lambda: cells.assign_cells_np(block, codebooks, "l2"), 1)},
        "host_rescore_window": {"shape": {"q": 8, "window": residency._DEFAULT_WINDOW, "d": vectors.shape[1]},
                                "per_request": "1 per probed host search",
                                "ms": host_ms(lambda: residency._host_rescore_topk(
                                    vectors, np.ones(vectors.shape[0], np.float32),
                                    -np.ones(vectors.shape[0], np.float32), None, queries,
                                    np.resize(sel, (queries.shape[0], residency._DEFAULT_WINDOW)).astype(np.int32),
                                    vectors.shape[0], IVFH_K, "l2"))},
    }
    for op, row in out["timings"].items():
        emit({"phase": "ivf_host_timing", "op": op, **row, "clock": "host", "device": kind, "nvidia_smi": smi})
    return out


# -- phase 10: mutations --------------------------------------------------------


class Live:
    """chip_smoke's host copy of a served table, mutated as the server's
    is: the float64 oracle's input. The vectors are a list of row blocks
    (an append adds one; no corpus-sized concatenation until a delete
    needs one). ``pos(ids)`` maps row ids to positions (-1: not in the
    table)."""

    def __init__(self, vectors, ids, tags):
        self.parts, self.ids, self.tags = [vectors], ids, tags

    def append(self, vectors, ids, tags) -> None:
        import numpy as np

        self.parts.append(vectors)
        self.ids = np.concatenate([self.ids, ids])
        self.tags = np.concatenate([self.tags, tags])

    def keep(self, mask) -> None:
        import numpy as np

        self.parts = [np.concatenate(self.parts)[mask] if len(self.parts) > 1 else self.parts[0][mask]]
        self.ids, self.tags = self.ids[mask], self.tags[mask]

    def pos(self, ids):
        import numpy as np

        top = int(self.ids.max())
        lookup = np.full(top + 1, -1, np.int64)
        lookup[self.ids] = np.arange(self.ids.shape[0])
        return np.where((ids >= 0) & (ids <= top), lookup[np.clip(ids, 0, top)], -1)


def appended_rows(rows: int, dim: int, first_id: int, copies, seed: int):
    """``rows`` new random rows (ids from ``first_id``, tags in [0, 100))
    whose first rows are exact copies of the query vectors ``copies``,
    tagged 0 (inside every filter of the phases)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((rows, dim), dtype=np.float32)
    tags = rng.integers(0, 100, rows, dtype=np.int32)
    for i, q in enumerate(copies):
        vectors[i], tags[i] = q, 0
    return vectors, np.arange(first_id, first_id + rows, dtype=np.int64), tags


def to_reader(vectors, ids, tags):
    """The rows as a one-batch reader of the smoke tables' schema."""
    import pyarrow as pa

    from fenix_tpu_torch.io import ingest

    batch = pa.record_batch([pa.array(ids), ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                             pa.array(tags)], names=["id", "vector", "tag"])
    return pa.RecordBatchReader.from_batches(batch.schema, iter([batch]))


def mutation_call(client, name: str, fn, counter: str) -> dict:
    """One mutation through the server: its client time and the server's
    ``counter`` seconds."""
    a = client.stats()
    t = time.perf_counter()
    value = fn()
    took = time.perf_counter() - t
    b = client.stats()
    return {"mutation": name, "client_s": took, "server_s": b[counter] - a.get(counter, 0),
            "value": value if isinstance(value, (int, dict)) else None}


def mutation_search(client, name: str, table_name: str, target, kw: dict, rises: dict) -> tuple:
    """The first search after a mutation: its counters must move by
    ``rises``; returns the result and its printed row."""
    a = client.stats()
    t = time.perf_counter()
    result = client.search(target, table_name, "vector", **kw)
    took = time.perf_counter() - t
    b = client.stats()
    check_counter_rises(name, a, b, rises)
    keys = ("search.seconds", "cache.refresh_seconds", "cache.host_load_seconds", "filter.seconds",
            "transfer.h2d_bytes", "cache.incremental_refreshes", "cache.lineage_refreshes",
            "cache.mirror_rows_quantized", "cache.mirror_delta_refreshes", *(f"kernel.bucket_scores.{k}.launches"
                                                                              for k in ALL_LAUNCH_KEYS))
    return result, {"search": name, "first_client_ms": took * 1e3,
                    **{k: b.get(k, 0) - a.get(k, 0) for k in keys},
                    **{f"route.{r}": b.get(c, 0) - a.get(c, 0) for r, c in IVF_ROUTES.items()}}


def check_live(live: Live, name: str, metric: str, k: int, queries, result, precision="fp32",
               mask_fn=None) -> dict:
    """A search over a mutated table held to the float64 oracle over the
    live copy (phase 4's rule; ``precision`` "int8" grades by recall):
    result ids map to live positions, so a row the mutations removed
    fails. ``mask_fn(oracle_device)`` gives the oracle's mask."""
    import torch

    qn = queries.shape[0]
    ids, dist = split_result(result, qn, k)
    pos = live.pos(ids)  # padding (-1) stays -1
    if ((pos < 0) & (ids >= 0)).any():
        raise AssertionError(f"{name}: {int(((pos < 0) & (ids >= 0)).sum())} returned ids are not in the table")
    oracle = Oracle(live.parts, DEVICE)
    mask = mask_fn(oracle.device) if mask_fn is not None else None
    out = check_ids(oracle, name, metric, k, precision, queries, pos, dist, mask, require_ties=False)
    del oracle, mask
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_mutations_serve(client, expr, vectors, ids_np, tags, queries, ivf: dict, cold_s: float,
                          smi: str, kind: str) -> dict:
    """Phase 10 (a) on the phase-3 server after phase 8. (1) append
    MUT_APPEND_ROWS rows (row 0 copies the Q=8 cosine search's query 0,
    row 1 phase 7's Q=8 p64 search's query 0): the index extends, the Q=8
    cosine search grows the matrix (one incremental refresh, one stream
    launch, under MUT_H2D_FACTOR x the delta uploaded) and finds row 0
    first, the Q=8 p64 search finds row 1 first; (2) delete tag == 7: the
    Q=1024 filtered search refreshes by the lineage (one tiled launch) and
    returns no deleted id; (3) upsert 2 x MUT_UPSERT rows by id; (4)
    compact: the next search takes the lineage's identity hop and uploads
    nothing. Every search is held to the float64 oracle over the live
    copy. Returns the path's launches and what (c) needs."""
    import numpy as np
    import torch

    start_launches = launches(client)
    live = Live(vectors, ids_np, tags)
    rows0 = vectors.shape[0]
    cos = next(i for i, sp in enumerate(SEARCHES) if sp[0] == "q8_cosine_k10")
    big = next(i for i, sp in enumerate(SEARCHES) if sp[0] == "q1024_l2_k100_filtered")
    ivf_q, _ = ivf["searches"]["ivf_q8_p64_filtered"]
    cos_kw = dict(metric="cosine", maxval=SEARCHES[cos][3])
    big_kw = dict(metric="l2", maxval=SEARCHES[big][3], filter=expr.field("tag") < 50)
    dim = vectors.shape[1]
    rows, steps = [], {}

    # (1) append
    new = appended_rows(MUT_APPEND_ROWS, dim, rows0, (queries[cos][0], ivf_q[0]), seed=600)
    live.append(*new)
    rows.append(mutation_call(client, "append", lambda: client.append_table("smoke/items", to_reader(*new)),
                              "put.seconds"))
    coded = client.read_table("smoke/items", select=["__CODED_ID__"], coding=IVF_CODER, column="vector").read_all()
    codes = np.array(coded.column(0).to_numpy())
    if codes.shape[0] != live.ids.shape[0]:
        raise AssertionError(f"the index holds {codes.shape[0]} rows, the table {live.ids.shape[0]}")
    stream = f"kernel.{'stream'}"
    result, row = mutation_search(client, "append_q8_cosine", "smoke/items", queries[cos], cos_kw, {
        "cache.incremental_refreshes": 1, "cache.lineage_refreshes": 0, **launch_rises((stream,), 1)})
    delta_bytes = MUT_APPEND_ROWS * dim * 4
    if DEVICE == "cuda" and not 0 < row["transfer.h2d_bytes"] < MUT_H2D_FACTOR * delta_bytes:
        raise AssertionError(f"append refresh uploaded {row['transfer.h2d_bytes']} bytes for a "
                             f"{delta_bytes}-byte delta")
    if split_result(result, 8, cos_kw["maxval"])[0][0, 0] != rows0:
        raise AssertionError("the appended copy of query 0 is not its first result")
    row["oracle"] = check_live(live, "append_q8_cosine", "cosine", cos_kw["maxval"], queries[cos], result)
    steps["append"] = row
    _, _, probes, _, precision, _, metric = next(sp for sp in IVF_SEARCHES if sp[0] == "ivf_q8_p64_filtered")
    ivf_kw = dict(metric=metric, maxval=IVF_K, precision=precision, coding=IVF_CODER, probes=probes,
                  filter=expr.field("tag") < 50)
    result, row = mutation_search(client, "append_ivf_q8_p64", "smoke/items", ivf_q, ivf_kw, {})
    if sum(row[f"route.{r}"] for r in IVF_ROUTES) != 1:
        raise AssertionError(f"append_ivf_q8_p64 took no single IVF route: {row}")
    if split_result(result, 8, IVF_K)[0][0, 0] != rows0 + 1:
        raise AssertionError("the probed search does not find the appended copy of its query 0")
    probe = server_cells(ivf_q, ivf["codebooks"], "l2", probes, "mutations.append_ivf_q8_p64")
    row["oracle"] = check_live(live, "append_ivf_q8_p64", "l2", IVF_K, ivf_q, result, mask_fn=lambda dev: probe_mask(
        torch.from_numpy(codes).to(dev), probe, torch.from_numpy(live.tags).to(dev)))
    steps["append_probed"] = row
    grown_rows = live.ids.shape[0]

    # (2) delete tag == 7
    deleted_ids = live.ids[live.tags == 7]
    rows.append(mutation_call(client, "delete_tag_eq_7",
                              lambda: client.delete_rows("smoke/items", expr.field("tag") == 7), "delete-rows.seconds"))
    if rows[-1]["value"] != deleted_ids.shape[0]:
        raise AssertionError(f"deleted {rows[-1]['value']} rows, the copy {deleted_ids.shape[0]}")
    keep = live.tags != 7
    live.keep(keep)
    tiled = f"kernel.{'tiled'}"
    result, row = mutation_search(client, "delete_q1024_l2", "smoke/items", queries[big], big_kw, {
        "cache.incremental_refreshes": 0, "cache.lineage_refreshes": 1, **launch_rises((tiled,), 1)})
    if np.isin(np.asarray(result.column("id")), deleted_ids).any():
        raise AssertionError("a deleted id was returned")
    row["oracle"] = check_live(live, "delete_q1024_l2", "l2", big_kw["maxval"], queries[big], result,
                               mask_fn=lambda dev: torch.from_numpy(live.tags < 50).to(dev))
    steps["delete"] = row

    # (3) upsert by id: MUT_UPSERT existing ids with new vectors, MUT_UPSERT new ids
    rng = np.random.default_rng(601)
    replaced = np.sort(rng.choice(live.ids, MUT_UPSERT, replace=False))
    fresh_ids = np.arange(rows0 + MUT_APPEND_ROWS, rows0 + MUT_APPEND_ROWS + MUT_UPSERT, dtype=np.int64)
    payload = (rng.standard_normal((2 * MUT_UPSERT, dim), dtype=np.float32),
               np.concatenate([replaced, fresh_ids]), rng.integers(0, 100, 2 * MUT_UPSERT, dtype=np.int32))
    rows.append(mutation_call(client, "upsert", lambda: client.upsert_rows("smoke/items", to_reader(*payload)),
                              "put.seconds"))
    if rows[-1]["value"] != {"replaced": MUT_UPSERT, "inserted": MUT_UPSERT}:
        raise AssertionError(f"upsert answered {rows[-1]['value']}")
    live.keep(~np.isin(live.ids, replaced))
    live.append(*payload)
    # the keep-mask hop and the appended part in one refresh, counted as
    # one lineage refresh (the JAX package's count)
    result, row = mutation_search(client, "upsert_q8_cosine", "smoke/items", queries[cos], cos_kw, {
        "cache.incremental_refreshes": 0, "cache.lineage_refreshes": 1, **launch_rises((stream,), 1)})
    row["oracle"] = check_live(live, "upsert_q8_cosine", "cosine", cos_kw["maxval"], queries[cos], result)
    steps["upsert"] = row

    # (4) compact: an identity hop, nothing uploaded
    rows.append(mutation_call(client, "compact", lambda: client.compact_table("smoke/items"), "compact.seconds"))
    result, row = mutation_search(client, "compact_q8_cosine", "smoke/items", queries[cos], cos_kw, {
        "cache.incremental_refreshes": 0, "cache.lineage_refreshes": 1, "transfer.h2d_bytes": 0,
        **launch_rises((stream,), 1)})
    row["oracle"] = check_live(live, "compact_q8_cosine", "cosine", cos_kw["maxval"], queries[cos], result)
    steps["compact"] = row

    for r in rows:
        emit({"phase": "mutation", **r, "device": kind, "nvidia_smi": smi})
    for name, r in steps.items():
        emit({"phase": "mutation_search", "after": name, **r, "cold_upload_first_call_s": cold_s,
              "device": kind, "nvidia_smi": smi})
    after = launches(client)
    return {"launches": {k: v - start_launches[k] for k, v in after.items()}, "append": new,
            "grown_rows": grown_rows, "keep_after_append": keep}


def phase_mutations_wide(client, expr, vectors, ids_np, tags, res_queries, ivfh: dict, smi: str, kind: str) -> dict:
    """Phase 10 (b) on the phase-6 server after phase 9: append
    MUT_APPEND_ROWS x 768 rows (row 0 copies the auto Q=8 search's query 0,
    row 1 phase 9's Q=8 p64 search's query 0); the auto Q=8 l2 top-100
    search then quantizes exactly the delta (one mirror delta refresh),
    grows the int8-resident copy (one incremental refresh, one tensor_int8
    launch), keeps no fp32 matrix and stays within the budget, reaches
    recall@100 >= 0.99 and finds row 0 first; phase 9's Q=8 p64 search
    finds row 1 first, so the index was extended on the host."""
    import numpy as np
    import torch

    live = Live(vectors, ids_np, tags)
    rows0 = vectors.shape[0]
    q8 = res_queries[8]
    ivf_name = IVFH_SEARCHES[-1][0]
    ivf_q, ivf_kw, _ = ivfh["searches"][ivf_name]
    kw = dict(metric="l2", maxval=RES_K, filter=expr.field("tag") < 50)
    # phase 9's make-index cleared the cache: the int8-resident copy is
    # built again before the append, as a serving table's would be
    client.search(q8, "smoke/wide", "vector", **kw)
    start_launches = launches(client)
    new = appended_rows(MUT_APPEND_ROWS, vectors.shape[1], rows0, (q8[0], ivf_q[0]), seed=602)
    live.append(*new)
    row = mutation_call(client, "append_wide", lambda: client.append_table("smoke/wide", to_reader(*new)),
                        "put.seconds")
    a = client.stats()
    emit({"phase": "mutation", **row, "host_assigns": a.get("index.host_assigns", 0), "device": kind,
          "nvidia_smi": smi})
    result, srow = mutation_search(client, "append_auto_q8", "smoke/wide", q8, kw, {
        "cache.mirror_rows_quantized": MUT_APPEND_ROWS, "cache.mirror_delta_refreshes": 1,
        "cache.incremental_refreshes": 1, "search.residency_int8": 1, **launch_rises(("kernel.tensor_int8",), 1)})
    st = client.stats()
    if st.get("cache.device_entries.matrix", 0):
        raise AssertionError("an fp32 device matrix exists after the int8-resident append")
    if st["cache.device_bytes"] > RES_BUDGET:
        raise AssertionError(f"cache.device_bytes {st['cache.device_bytes']} over the budget")
    if split_result(result, 8, RES_K)[0][0, 0] != rows0:
        raise AssertionError("the appended copy of query 0 is not its first result")
    srow["device_bytes"] = st["cache.device_bytes"]
    srow["oracle"] = check_live(live, "append_auto_q8", "l2", RES_K, q8, result, precision="int8",
                                mask_fn=lambda dev: torch.from_numpy(live.tags < 50).to(dev))
    emit({"phase": "mutation_search", "after": "append_wide", **srow, "device": kind, "nvidia_smi": smi})
    result, prow = mutation_search(client, "append_host_ivf_q8_p64", "smoke/wide", ivf_q, ivf_kw,
                                   {"search.residency_probed_host": 1, **launch_rises(ALL_LAUNCH_KEYS, 0)})
    if split_result(result, 8, IVFH_K)[0][0, 0] != rows0 + 1:
        raise AssertionError("the probed host search does not find the appended copy of its query 0")
    emit({"phase": "mutation_search", "after": "append_wide_probed", **prow, "device": kind, "nvidia_smi": smi})
    after = launches(client)
    return {"launches": {k: v - start_launches[k] for k, v in after.items()}, "append": new}


def mutation_kernel_checks(kernels, topk2, vectors, tags, queries, mut: dict, smi: str, kind: str) -> list[dict]:
    """Phase 10 (c), the phase-3 table: the kernels against their plain
    versions at the inputs (a)'s searches give them, the buffers built by
    the cache's own grow and shrink: the stream kernel over the matrix
    grown by the append (Q=8 cosine; padding rows zero), the tiled kernel
    over the matrix shrunk by the delete (Q=1024 l2, tag < 50); then the
    grow and the shrink timed alone."""
    import numpy as np
    import torch

    from fenix_tpu_torch.engine import session
    from fenix_tpu_torch.io import ingest

    out = []
    rows0, dim = vectors.shape
    new_v, _, new_t = mut["append"]
    old = ingest.to_device_matrix(vectors, block=session.DEFAULT_BLOCK, device=DEVICE)
    grown_rows = rows0 + new_v.shape[0]
    pad = max(ingest.round_up(grown_rows, session.DEFAULT_BLOCK), session.DEFAULT_BLOCK, old.rows_padded)
    grown = session._grown(old.data, new_v, rows0, pad, 0)
    if grown[grown_rows:].any():
        raise AssertionError("the grown matrix has nonzero padding rows")
    qi = next(i for i, sp in enumerate(SEARCHES) if sp[0] == "q8_cosine_k10")
    mul, add = topk2.prepare_aux(grown, torch.arange(pad, device=DEVICE) < grown_rows, "cosine")
    qp = topk2.prepare_queries(torch.from_numpy(queries[qi]).to(DEVICE), "cosine").contiguous()
    bucket = topk2.bucket_for(8, pad)
    out.append({"search": "mutation_append_q8_cosine", "route": "f32", "q": 8, "n": pad, "bucket": bucket,
                **compare(kernels, qp, grown, mul, add, bucket, None)})
    grow_ms = time_ms(lambda: session._grown(old.data, new_v, rows0, pad, 0), TIMING_REPS)
    del old, mul, add

    keep = mut["keep_after_append"]
    idx = np.flatnonzero(keep).astype(np.int32)
    kept = int(idx.size)
    kpad = max(ingest.round_up(kept, session.DEFAULT_BLOCK), session.DEFAULT_BLOCK)
    idx_dev = torch.from_numpy(idx).to(DEVICE)

    def shrink():  # session._shrink_matrix's gather
        data = torch.zeros((kpad, dim), dtype=grown.dtype, device=DEVICE)
        torch.index_select(grown, 0, idx_dev, out=data[:kept])
        return data

    shrunk = shrink()
    qi = next(i for i, sp in enumerate(SEARCHES) if sp[0] == "q1024_l2_k100_filtered")
    valid = torch.zeros(kpad, dtype=torch.bool, device=DEVICE)
    valid[:kept] = torch.from_numpy(np.concatenate([tags, new_t])[keep] < 50).to(DEVICE)
    mul, add = topk2.prepare_aux(shrunk, valid, "l2")
    qp = topk2.prepare_queries(torch.from_numpy(queries[qi]).to(DEVICE), "l2").contiguous()
    bucket = topk2.bucket_for(1024, kpad)
    out.append({"search": "mutation_delete_q1024_l2", "route": "f32", "q": 1024, "n": kpad, "bucket": bucket,
                **compare(kernels, qp, shrunk, mul, add, bucket, None)})
    shrink_ms = time_ms(shrink, TIMING_REPS)
    del grown, shrunk, mul, add, valid, idx_dev
    for r in out:
        emit({"phase": "kernel_vs_plain_mutation_path", **r})
    timings = {
        "grow": {"shape": {"rows": rows0, "delta": int(new_v.shape[0]), "d": dim, "pad": pad},
                 "per_request": "1 per append hop", "ms": grow_ms},
        "shrink": {"shape": {"rows": grown_rows, "kept": kept, "d": dim, "pad": kpad},
                   "per_request": "1 per delete hop", "ms": shrink_ms},
    }
    for op, row in timings.items():
        emit({"phase": "mutation_timing", "op": op, **row, "device": kind, "nvidia_smi": smi})
    return out


def mutation_kernel_checks_wide(kernels, topk2, vectors, tags, res_queries, append, smi: str, kind: str) -> list:
    """Phase 10 (c), the phase-6 table: tensor_int8 against its plain
    version over the int8 copy grown by (b)'s append as the cache grows
    it (zero codes and scale 1e-30 on the padding rows), at the auto Q=8
    l2 search's inputs (tag < 50); then the delta's host quantize timed
    alone."""
    import numpy as np
    import torch

    from fenix_tpu_torch.engine import session
    from fenix_tpu_torch.io import ingest

    rows0, dim = vectors.shape
    new_v, _, new_t = append
    corpus = torch.from_numpy(vectors).to(DEVICE)
    v8, sv = topk2.quantize_corpus_int8(corpus)
    sq = (corpus * corpus).sum(dim=1)
    del corpus
    d8, dsv = topk2.quantize_rows_int8_np(new_v)
    rows = rows0 + new_v.shape[0]
    pad = max(ingest.round_up(rows, session.DEFAULT_BLOCK), session.DEFAULT_BLOCK, v8.shape[0])
    g8 = session._grown(v8, d8, rows0, pad, 0)
    gsv = session._grown(sv[:rows0], dsv, rows0, pad, 1e-30)
    del v8, sv
    add = torch.full((pad,), float("-inf"), device=DEVICE)
    sq_all = torch.cat([sq[:rows0], torch.from_numpy(np.einsum("nd,nd->n", new_v, new_v)).to(DEVICE)])
    ok = torch.from_numpy(np.concatenate([tags, new_t]) < 50).to(DEVICE)
    add[:rows] = torch.where(ok, -sq_all, float("-inf"))
    q8, inv_sq = topk2.quantize_queries_int8(
        topk2.prepare_queries(torch.from_numpy(res_queries[8]).to(DEVICE), "l2").contiguous())
    bucket = topk2.bucket_for(8, pad)
    row = {"search": "mutation_append_auto_q8", "route": "int8", "q": 8, "n": pad, "d": dim, "bucket": bucket,
           **compare(kernels, q8, g8, gsv, add, bucket, inv_sq)}
    emit({"phase": "kernel_vs_plain_mutation_path", **row})
    del g8, gsv, add, sq, sq_all, ok
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "mutation_timing", "op": "delta_quantize", "clock": "host",
          "shape": {"rows": int(new_v.shape[0]), "d": dim}, "per_request": "1 per append hop of the int8 mirror",
          "ms": host_ms(lambda: topk2.quantize_rows_int8_np(new_v)), "device": kind, "nvidia_smi": smi})
    return [row]


# -- phase 11: analytics (BASELINE config 3) ------------------------------------


def analytics_tables():
    """BASELINE config 3's attribute table as benchmarks/config3_join_aggregate.py
    builds it at scale 1 (a key per search-table id and more, grp = key % 100,
    a float64 weight), and attrs_dup: AN_DUP_ROWS rows, four per key, for the
    inner join."""
    import numpy as np

    rng = np.random.default_rng(0)
    key = rng.permutation(AN_ATTRS_ROWS)
    attrs = {"key": key, "grp": key % 100, "weight": rng.standard_normal(AN_ATTRS_ROWS)}
    i = np.arange(AN_DUP_ROWS, dtype=np.int64)
    dup = {"key": i // 4, "grp": i % 16, "val": (i * 7919) % 1000 - 500}
    return attrs, dup


def put_columns(client, name: str, cols: dict) -> float:
    """Ingest numpy columns as a table over Flight in AN_BATCH_ROWS batches;
    returns the client seconds."""
    import pyarrow as pa

    rows = len(next(iter(cols.values())))
    schema = pa.schema({k: pa.from_numpy_dtype(v.dtype) for k, v in cols.items()})

    def batches():
        for s in range(0, rows, AN_BATCH_ROWS):
            yield pa.record_batch([pa.array(v[s : s + AN_BATCH_ROWS]) for v in cols.values()], schema=schema)

    t = time.perf_counter()
    client.make_table(name, pa.RecordBatchReader.from_batches(schema, batches()))
    return time.perf_counter() - t


def timed_search(client, name: str, target, kw: dict, rises: dict, reps: int,
                 table_name: str = "smoke/items") -> tuple:
    """One cold call and ``reps`` warm ones of a search, each moving the
    counters of ``rises`` by their amounts. Returns the first result, the
    client and server milliseconds of every call, the launches summed over
    the calls, and the stats around the first call."""
    result, client_ms, server_ms, total, first = None, [], [], {}, None
    for _ in range(1 + reps):
        a = client.stats()
        t = time.perf_counter()
        got = client.search(target, table_name, "vector", **kw)
        client_ms.append((time.perf_counter() - t) * 1e3)
        b = client.stats()
        check_counter_rises(name, a, b, rises)
        server_ms.append((b["search.seconds"] - a.get("search.seconds", 0)) * 1e3)
        la, lb = launches(None, a), launches(None, b)
        for k in lb:
            total[k] = total.get(k, 0) + lb[k] - la[k]
        if result is None:
            result, first = got, (a, b)
    return result, client_ms, server_ms, total, first


def phase_analytics_serve(client, expr, kernels, vectors, smi: str, kind: str) -> dict:
    """Phase 11 on the phase-3 server after phase 8: ingest attrs and
    attrs_dup, then each request of AN_REQUESTS without its join (the plain
    search the oracle holds) and with it, one cold and WARM_REPS warm calls
    each. A join call moves its route's join counter by one, the others by
    none, and its kernel's launches by one (none on the probed route).
    Returns the results and the join calls' launches (the analytics path)."""
    import numpy as np
    import torch

    attrs, dup = analytics_tables()
    emit({"phase": "analytics_put", "table": "attrs", "rows": AN_ATTRS_ROWS,
          "client_s": put_columns(client, "attrs", attrs)})
    emit({"phase": "analytics_put", "table": "attrs_dup", "rows": AN_DUP_ROWS,
          "client_s": put_columns(client, "attrs_dup", dup)})
    scan_dtypes = {"fp32": torch.float32, "int8": torch.int8}
    routes = ("join.fused", "join.two_step", "join.inner")
    results, path = {}, {}
    for name, qn, metric, k, precision, filtered, probes, join, aggregate, route, seed in AN_REQUESTS:
        queries = make_queries(vectors, qn, seed=seed)
        target = queries[0] if qn == 1 else queries
        kw = dict(metric=metric, maxval=k, precision=precision,
                  filter=(expr.field("tag") < 50) if filtered else None)
        if probes is not None:
            kw.update(coding=IVF_CODER, probes=probes)
            keys, design = (), None
        else:
            design = kernels.kernel_for(scan_dtypes[precision], qn, D)
            keys = (ROUTES[precision], f"kernel.{design}")
        plain, plain_ms, plain_server, _, _ = timed_search(
            client, name + " (plain)", target, kw, launch_rises(keys, 1), WARM_REPS)
        rises = {**{r: int(r == route) for r in routes}, **launch_rises(keys or ALL_LAUNCH_KEYS, int(bool(keys)))}
        joined, join_ms, join_server, total, (a, b) = timed_search(
            client, name, target, {**kw, "join": join, "aggregate": aggregate}, rises, WARM_REPS)
        for key, v in total.items():
            path[key] = path.get(key, 0) + v
        calls = 1 + WARM_REPS
        emit({"phase": "analytics_search", "search": name, "q": qn, "metric": metric, "k": k,
              "precision": precision, "filtered": filtered, "probes": probes, "route": route,
              "kernel": design, "rows_returned": joined.num_rows,
              "sorted_key_build_s": b.get("cache.sorted_key_seconds", 0) - a.get("cache.sorted_key_seconds", 0),
              "first_client_ms": join_ms[0], "first_server_ms": join_server[0],
              "warm_client_median_ms": float(np.median(join_ms[1:])),
              "warm_server_median_ms": float(np.median(join_server[1:])),
              "plain_first_client_ms": plain_ms[0],
              "plain_warm_client_median_ms": float(np.median(plain_ms[1:])),
              "plain_warm_server_median_ms": float(np.median(plain_server[1:])),
              "join_cost_warm_server_ms": float(np.median(join_server[1:]) - np.median(plain_server[1:])),
              "launches_per_call": {k: v / calls for k, v in total.items() if v},
              "device": kind, "nvidia_smi": smi})
        results[name] = (queries, plain, joined)
    emit({"phase": "analytics_served", "launches": path})
    return {"results": results, "launches": path, "attrs": attrs, "dup": dup}


def check_groups(name: str, got, groups, values, agg: str, int_lane: bool) -> dict:
    """An aggregate table held to numpy over the joined rows' group keys and
    values: the groups in ascending order; integer aggregates equal and
    typed int64; float sums and means within 1e-5 * sum |v| of their group;
    min and max equal (of the values as the card holds them, float32)."""
    import numpy as np
    import pyarrow as pa

    uniq, inv = np.unique(groups, return_inverse=True)
    if got.column("__GROUP__").to_pylist() != uniq.tolist():
        raise AssertionError(f"{name}: groups {got.column('__GROUP__').to_pylist()[:8]}... "
                             f"differ from the oracle's {uniq.tolist()[:8]}...")
    agg_col = got.column("__AGG__")
    vals = agg_col.to_numpy()
    worst = 0.0
    for slot in range(uniq.size):
        v = values[inv == slot]
        if agg in ("min", "max"):
            want = float(getattr(np, agg)(v.astype(np.float32)))
            if vals[slot] != want:
                raise AssertionError(f"{name}: group {uniq[slot]} {agg} {vals[slot]} != {want}")
            continue
        want = v.sum() if agg in ("sum", "count") else v.sum() / v.size
        if int_lane and agg != "mean":
            if vals[slot] != want:
                raise AssertionError(f"{name}: group {uniq[slot]} {agg} {vals[slot]} != {want}")
            continue
        err = abs(float(vals[slot]) - float(want))
        if err > 1e-5 * float(np.abs(v).sum()):
            raise AssertionError(f"{name}: group {uniq[slot]} {agg} off by {err}")
        worst = max(worst, err / max(float(np.abs(v).sum()), 1e-30))
    if int_lane and agg != "mean" and agg_col.type != pa.int64():
        raise AssertionError(f"{name}: integer aggregate typed {agg_col.type}")
    return {"groups": int(uniq.size), "max_rel_err_of_sum_abs": worst}


def phase_analytics_checks(oracle, tags, ivf: dict, an: dict, label: str = "analytics_oracle") -> list[dict]:
    """Phase 11 after the server: each plain search against the float64
    oracle by phase 4's rule (the probed one over its probe cells, as
    phase 7), then its join and aggregate in numpy on the host copy of
    the attribute tables. Phase 15 (d) holds its mesh answers so too,
    each line under ``label``."""
    import numpy as np
    import pyarrow as pa
    import torch

    attrs, dup = an["attrs"], an["dup"]
    codes_dev = torch.from_numpy(ivf["codes"]).to(oracle.device)
    tag_mask_dev = torch.from_numpy(tags < 50).to(oracle.device)
    out = []
    for name, qn, metric, k, precision, filtered, probes, join, aggregate, route, _ in AN_REQUESTS:
        queries, plain, joined = an["results"][name]
        ids, dist = split_result(plain, qn, k)
        if probes is not None:
            mask = probe_mask(codes_dev, server_cells(queries, ivf["codebooks"], metric, probes, f"{label}.{name}"), None)
        else:
            mask = tag_mask_dev if filtered else None
        row = {"search": name, **check_ids(oracle, name, metric, k, precision, queries, ids, dist, mask,
                                           require_ties=False)}
        if aggregate is None:
            left, right, table = oracle_join(plain, join, attrs, dup)
            want = plain.take(pa.array(left))
            for col in join.get("columns") or [c for c in table if c != join["right_on"]]:
                want = want.append_column(col, pa.array(table[col][right]))
            if not joined.equals(want):
                raise AssertionError(f"{name}: joined rows differ from the oracle's rows in (left row, right row) "
                                     "order with the attributes gathered")
            row["rows"] = joined.num_rows
        else:
            row.update(check_groups(name, joined, *oracle_groups(plain, join, aggregate, attrs, dup),
                                    aggregate["agg"], aggregate.get("value") is None))
        out.append(row)
        emit({"phase": label, **row})
    return out


def oracle_join(plain, join: dict, attrs: dict, dup: dict):
    """Phase 11's join in numpy on the host copy of the attribute tables:
    the (left row, attribute row) pairs of a plain search's rows in (left
    row, right row) order, and the attribute table's columns."""
    import numpy as np

    ids = np.asarray(plain.column("id"))
    if join["source"] == "attrs":  # every search id matches exactly one attrs row
        row_of_key = np.empty(AN_ATTRS_ROWS, np.int64)
        row_of_key[attrs["key"]] = np.arange(AN_ATTRS_ROWS)
        return np.arange(ids.size), row_of_key[ids], attrs
    hit = ids < AN_DUP_ROWS // 4  # attrs_dup: id i < AN_DUP_ROWS / 4 matches rows 4i .. 4i+3
    return np.repeat(np.flatnonzero(hit), 4), (4 * ids[hit][:, None] + np.arange(4)).ravel(), dup


def oracle_groups(plain, join: dict, aggregate: dict, attrs: dict, dup: dict):
    """The joined rows' (group keys, values) of a plain search's rows
    (oracle_join): the value column, the distances, or ones for a count."""
    import numpy as np

    left, right, table = oracle_join(plain, join, attrs, dup)
    value = aggregate.get("value")
    if value is None:
        values = np.ones(right.size, np.int64)
    elif value == "__DISTANCE__":
        values = np.asarray(plain.column("__DISTANCE__")).astype(np.float64)[left]
    else:
        values = table[value][right]
    return table[aggregate["group_by"]][right], values


# -- phase 12: micro-batching ----------------------------------------------------


def mb_filter(expr, pred):
    """A phase-12 predicate: None, ("<", v) or ("range", lo, hi)."""
    if pred is None:
        return None
    if pred[0] == "<":
        return expr.field("tag") < pred[1]
    return (expr.field("tag") >= pred[1]) & (expr.field("tag") < pred[2])


def run_jobs(Flight, port: int, table_name: str, jobs: list, threads: int) -> tuple:
    """Each job ``(target, kw)`` as one search: with ``threads`` 0 one after
    the other on one client, else job i on thread i % threads, each thread
    with its own client, all started together. Returns the results in job
    order, each job's client milliseconds and the wall seconds."""
    import threading

    results, lat, errors = [None] * len(jobs), [0.0] * len(jobs), []

    def worker(w: int, step: int) -> None:
        client = Flight(host="127.0.0.1", port=port)
        try:
            for i in range(w, len(jobs), step):
                t = time.perf_counter()
                results[i] = client.search(jobs[i][0], table_name, "vector", **jobs[i][1])
                lat[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            errors.append(exc)
        finally:
            client.close()

    t = time.perf_counter()
    if threads == 0:
        worker(0, 1)
    else:
        pool = [threading.Thread(target=worker, args=(w, threads)) for w in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join()
    wall = time.perf_counter() - t
    if errors:
        raise errors[0]
    return results, lat, wall


MB_COUNTERS = ("batch.dispatches", "batch.requests", "batch.queries", "batch.drains", "search.ivf_clustered",
               "search.ivf_scan", "search.residency_int8")


def batching_case(client, Flight, port: int, table_name: str, name: str, jobs: list, threads: int,
                  graded: bool, smi: str, kind: str) -> dict:
    """One case of phase 12: the jobs one at a time (each a batch of one:
    the solo answers), then from ``threads`` client threads. Every
    concurrent table must equal its solo one (``graded``: int8 phase 1,
    recall >= 0.99 of the solo ids, equal distances on shared ids). Returns
    the printed row with the concurrent part's counters and launches."""
    import numpy as np

    solo, solo_ms, solo_wall = run_jobs(Flight, port, table_name, jobs, 0)
    a = client.stats()
    got, conc_ms, conc_wall = run_jobs(Flight, port, table_name, jobs, threads)
    b = client.stats()
    equal = 0
    for i, (g, s) in enumerate(zip(got, solo)):
        if g.equals(s):
            equal += 1
        elif not graded:
            raise AssertionError(f"{name}: concurrent request {i} differs from its solo answer")
        else:
            check_graded(f"{name}[{i}]", g, s)
    la, lb = launches(None, a), launches(None, b)
    counters = {k: b.get(k, 0) - a.get(k, 0) for k in MB_COUNTERS}
    used = {k: lb[k] - la[k] for k in lb if lb[k] != la[k]}
    queries = counters["batch.queries"]
    row = {"phase": "batching", "case": name, "requests": len(jobs), "threads": threads,
           "queries_per_request": queries / max(counters["batch.requests"], 1), **counters,
           "requests_per_dispatch": counters["batch.requests"] / max(counters["batch.dispatches"], 1),
           "queries_per_dispatch": queries / max(counters["batch.dispatches"], 1),
           "equal_to_solo": equal, "launches": used,
           "launches_per_request": {k: v / len(jobs) for k, v in used.items()},
           "solo_qps": len(jobs) / solo_wall, "concurrent_qps": len(jobs) / conc_wall,
           "solo_p50_ms": float(np.percentile(solo_ms, 50)), "solo_p99_ms": float(np.percentile(solo_ms, 99)),
           "concurrent_p50_ms": float(np.percentile(conc_ms, 50)),
           "concurrent_p99_ms": float(np.percentile(conc_ms, 99)),
           "max_memory_allocated": b.get("device.max_memory_allocated"), "device": kind, "nvidia_smi": smi}
    if counters["batch.requests"] != len(jobs):
        raise AssertionError(f"{name}: {counters['batch.requests']} batched requests, expected {len(jobs)}")
    emit(row)
    return row


def check_graded(name: str, got, solo) -> None:
    """The parity contract's graded-selection rule against the solo answer:
    recall >= 0.99 of its ids per table, the same distance on every id both
    return (the rescore is exact fp32)."""
    import numpy as np

    def per_query(t):
        qid = t.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in t.column_names else np.zeros(t.num_rows)
        return qid, t.column("id").to_numpy(), t.column("__DISTANCE__").to_numpy()

    gq, gi, gd = per_query(got)
    sq, si, sd = per_query(solo)
    hits = 0
    for q in np.unique(sq):
        g = dict(zip(gi[gq == q].tolist(), gd[gq == q].tolist()))
        s = dict(zip(si[sq == q].tolist(), sd[sq == q].tolist()))
        shared = g.keys() & s.keys()
        hits += len(shared)
        if any(g[i] != s[i] for i in shared):
            raise AssertionError(f"{name}: a shared id has another distance than alone")
    if hits < 0.99 * si.size:
        raise AssertionError(f"{name}: recall {hits / si.size} of the solo ids < 0.99")


def phase_batching_serve(client, Flight, port: int, expr, vectors, smi: str, kind: str) -> dict:
    """Phase 12 (a)-(d) on the phase-3 server after phase 11. Returns each
    case's row and the phase's launches (the batching path)."""
    c0 = launches(client)
    cases = {}
    q1 = make_queries(vectors, MB_Q1_REQUESTS, seed=600)
    cos = dict(metric="cosine", maxval=10)
    # (a) Q=1 from MB_THREADS threads
    jobs = [(q1[i], cos) for i in range(MB_Q1_REQUESTS)]
    cases["a"] = batching_case(client, Flight, port, "smoke/items", "q1_cosine_k10", jobs, MB_THREADS,
                               False, smi, kind)
    # (b) the same with three predicates by thread (config 5's rotation)
    jobs = [(q1[i], {**cos, "filter": mb_filter(expr, MB_PREDICATES[(i % MB_THREADS) % 3])})
            for i in range(MB_Q1_REQUESTS)]
    cases["b"] = batching_case(client, Flight, port, "smoke/items", "q1_cosine_k10_three_predicates", jobs,
                               MB_THREADS, False, smi, kind)
    if cases["b"]["batch.dispatches"] > 3 * cases["b"]["batch.drains"]:
        raise AssertionError("(b): more than one dispatch per predicate per drain")
    # (c) config 5's batch and k from a few threads, the predicate by round
    threads, per, qn, k = MB_BIG
    big = make_queries(vectors, qn * threads * per, seed=601).reshape(threads * per, qn, D)
    jobs = [(big[i], dict(metric="l2", maxval=k, filter=mb_filter(expr, MB_PREDICATES[(i // threads) % 3])))
            for i in range(threads * per)]
    cases["c"] = batching_case(client, Flight, port, "smoke/items", f"q{qn}_l2_k{k}_rotating", jobs, threads,
                               False, smi, kind)
    if cases["c"]["queries_per_dispatch"] <= qn:
        raise AssertionError(f"(c): {cases['c']['queries_per_dispatch']} queries per dispatch, not past {qn}")
    # (d) probed Q=1 on phase 7's coder
    threads, per, probes = MB_PROBED
    qp = make_queries(vectors, threads * per, seed=602)
    jobs = [(qp[i], dict(metric="l2", maxval=10, coding=IVF_CODER, probes=probes)) for i in range(threads * per)]
    cases["d"] = batching_case(client, Flight, port, "smoke/items", f"q1_l2_k10_p{probes}", jobs, threads,
                               False, smi, kind)
    d = cases["d"]
    if d["search.ivf_clustered"] + d["search.ivf_scan"] != d["batch.dispatches"]:
        raise AssertionError("(d): not one probed route per dispatch")
    for c in ("a", "b", "c"):
        if cases[c]["requests_per_dispatch"] <= 1:
            raise AssertionError(f"({c}): {cases[c]['requests_per_dispatch']} requests per dispatch, none coalesced")
    if DEVICE == "cuda" and cases["a"]["launches"].get("kernel.stream", 0) >= MB_Q1_REQUESTS:
        raise AssertionError("(a): no fewer stream launches than requests")
    c1 = launches(client)
    path = {k: c1[k] - c0[k] for k in c1}
    emit({"phase": "batching_served", "launches": path})
    return {"cases": cases, "launches": path}


def phase_batching_residency(client, Flight, port: int, vectors, smi: str, kind: str) -> dict:
    """Phase 12 (e) on the phase-6 server: Q=8 auto (int8-resident) from a
    few threads through the executor's one request path, one int8-resident
    pass per dispatch; each answer held to its solo one by the graded rule."""
    c0 = launches(client)
    threads, per, qn = MB_RES
    qs = make_queries(vectors, qn * threads * per, seed=603).reshape(threads * per, qn, RES_D)
    jobs = [(qs[i], dict(metric="l2", maxval=RES_K, residency="auto")) for i in range(threads * per)]
    row = batching_case(client, Flight, port, "smoke/wide", f"q{qn}_auto_int8_resident", jobs, threads, True,
                        smi, kind)
    if row["search.residency_int8"] != row["batch.dispatches"]:
        raise AssertionError("(e): not one int8-resident pass per dispatch")
    c1 = launches(client)
    return {"case": row, "launches": {k: c1[k] - c0[k] for k in c1}}


def gather_chunked_numpy(chunks, row_ids):
    """The result gather's vector rows by numpy indexing chunk by chunk,
    as executor._gather_chunked did before it called native.gather_rows:
    the timing's baseline."""
    import numpy as np

    starts = np.cumsum([0] + [c.shape[0] for c in chunks])
    which = np.searchsorted(starts, row_ids, side="right") - 1
    order = np.argsort(which, kind="stable")
    bounds = np.searchsorted(which[order], np.arange(len(chunks) + 1))
    out = np.empty((row_ids.shape[0], *chunks[0].shape[1:]), chunks[0].dtype)
    for c in np.flatnonzero(np.diff(bounds)):
        idx = order[bounds[c] : bounds[c + 1]]
        out[idx] = chunks[c][row_ids[idx] - starts[c]]
    return out


def gather_timing(vectors, result, smi: str, kind: str) -> dict:
    """The vector gather of phase 3's Q=1024 filtered result over the
    table's 65,536-row chunks (as the server holds it), on the host:
    numpy indexing (before) against native.gather_rows (after), equal."""
    import numpy as np

    from fenix_tpu_torch import native
    from fenix_tpu_torch.engine import executor

    chunks = [vectors[s : s + BATCH_ROWS] for s in range(0, vectors.shape[0], BATCH_ROWS)]
    row_ids = np.asarray(result.column("id")).astype(np.int64)
    if not np.array_equal(executor._gather_chunked(chunks, row_ids), gather_chunked_numpy(chunks, row_ids)):
        raise AssertionError("native gather differs from numpy indexing")
    row = {"phase": "gather_timing", "rows": int(row_ids.size), "chunks": len(chunks),
           "native_available": native.available(),
           "numpy_ms": host_ms(lambda: gather_chunked_numpy(chunks, row_ids), 5),
           "native_ms": host_ms(lambda: executor._gather_chunked(chunks, row_ids), 5),
           "device": kind, "nvidia_smi": smi}
    emit(row)
    return row


# -- phase 13: typed vector columns -------------------------------------------


def quint8_type(vectors):
    """The quint8 type dynamic quantization gives ``vectors`` (its
    parameters depend on their smallest and largest value only), so the
    rows quantize batch by batch with ``like=`` into the codes of one
    whole-matrix quantization."""
    import numpy as np

    from fenix_tpu_torch import types

    _, scale, shift = types.quint8.dynamic_quantize(np.array([vectors.min(), vectors.max()], np.float32))
    return types.QUInt8TensorType((vectors.shape[1],), scale, shift)


def typed_reader(ids_np, tags, column_of):
    """The rows as a reader of BATCH_ROWS batches whose vector column is
    ``column_of(start, stop)``, a typed array of those rows."""
    import pyarrow as pa

    rows = ids_np.shape[0]
    schema = pa.schema([pa.field("id", pa.int64()), pa.field("vector", column_of(0, 1).type),
                        pa.field("tag", pa.int32())])

    def batches():
        for s in range(0, rows, BATCH_ROWS):
            e = min(s + BATCH_ROWS, rows)
            yield pa.record_batch([pa.array(ids_np[s:e]), column_of(s, e), pa.array(tags[s:e])], schema=schema)

    return pa.RecordBatchReader.from_batches(schema, batches())


def stats_delta(a: dict, b: dict, keys) -> dict:
    return {k: b.get(k, 0) - a.get(k, 0) for k in keys}


COLD_KEYS = ("search.seconds", "cache.host_load_seconds", "transfer.h2d_bytes", "cache.device_bytes")


def phase_typed_serve(client, expr, kernels, vectors, ids_np, tags, queries, root: str, smi: str,
                      kind: str) -> dict:
    """Phase 13 on the phase-3 server after phase 12: ingest items_q8 and
    items_t, then on items_q8 the five phase-3 searches, a maxval=None
    read, make_index of an IVF4096 coder and a probed search, an append
    quantized with ``like=`` the table's type and a search finding its
    rows; on items_t two phase-3 searches, bit-equal to items. Every call
    moves its kernel design's launches by one (none for the read and the
    probed search). Returns what the checks after the server need and the
    path's launches."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch import coder, types
    from fenix_tpu_torch.io import ingest

    scan_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    start = launches(client)
    typ = quint8_type(vectors)
    codes = np.empty(vectors.shape, np.uint8)

    def q8_column(s, e):
        col = types.QUInt8TensorArray.from_numpy(vectors[s:e], like=typ)
        codes[s:e] = ingest.fixed_size_list_to_numpy(col.storage)
        return col

    t = time.perf_counter()
    client.make_table(TY_Q8, typed_reader(ids_np, tags, q8_column))
    put_q8 = time.perf_counter() - t
    t = time.perf_counter()
    client.make_table(TY_T, typed_reader(ids_np, tags, lambda s, e: types.TensorArray.from_numpy(vectors[s:e])))
    put_t = time.perf_counter() - t
    deq = types.quint8.dequantize_np(codes, typ.scale, typ.shift)
    emit({"phase": "typed_put", "rows": ROWS, "q8_client_s": put_q8, "tensor_client_s": put_t,
          "q8_codes_bytes": int(codes.nbytes), "tensor_bytes": int(vectors.nbytes), "scale": typ.scale,
          "shift": typ.shift, "max_abs_quantization_error": float(np.abs(deq - vectors).max())})

    # (a) the phase-3 searches on items_q8 (the first call of the first one
    # is the table's cold load: codes up, dequantized on the card)
    results = {}
    for spec, qnp in zip(SEARCHES, queries):
        name, qn, metric, k, precision, filtered, flat = spec
        kw = dict(metric=metric, maxval=k, precision=precision,
                  filter=(expr.field("tag") < 50) if filtered else None)
        if name == TY_SELECT:
            kw["select"] = ["id", "vector"]
        design = kernels.kernel_for(scan_dtypes[precision], qn, D)
        result, client_ms, server_ms, total, (a, b) = timed_search(
            client, "q8_" + name, qnp[0] if flat else qnp, kw,
            launch_rises((ROUTES[precision], f"kernel.{design}"), 1), TY_WARM_REPS, TY_Q8)
        if result.schema.field("__DISTANCE__").type != pa.float32():
            raise AssertionError(f"q8_{name}: distances typed {result.schema.field('__DISTANCE__').type}")
        emit({"phase": "typed_search", "table": TY_Q8, "search": name, "q": qn, "k": k, "metric": metric,
              "precision": precision, "filtered": filtered, "kernel": design, "rows_returned": result.num_rows,
              "first_call": stats_delta(a, b, COLD_KEYS), "first_client_ms": client_ms[0],
              "launches_before": launches(None, a), "launches_after": launches(None, b),
              "warm_client_median_ms": float(np.median(client_ms[1:])),
              "warm_server_median_ms": float(np.median(server_ms[1:])),
              "launches_per_call": {k: v / (1 + TY_WARM_REPS) for k, v in total.items() if v},
              "device": kind, "nvidia_smi": smi})
        results[name] = result
    # the selected vector column keeps its quint8 type and codes
    sel = results[TY_SELECT]
    lv = types.logical_vector(sel.schema.field("vector"))
    if lv.kind != "quint8" or lv.params != types.logical_vector(typ).params:
        raise AssertionError(f"the selected vector column came back as {sel.schema.field('vector')}")
    got_codes = ingest.fixed_size_list_to_numpy(types.typed_column(sel, "vector").combine_chunks().storage)
    if not np.array_equal(got_codes, codes[np.asarray(sel.column("id"))]):
        raise AssertionError("the selected vector column's codes are not the table's")

    # (b) a maxval=None read over the dequantized column
    read_queries = make_queries(vectors, TY_READ[1], seed=300)
    read = selection_read(client, expr, TY_READ, TY_Q8, read_queries, smi, kind, "search.nomax_selected",
                          pushdown=True)[0]

    # (c) IVF over the dequantized rows
    a = client.stats()
    t = time.perf_counter()
    client.make_index(TY_CODER, TY_Q8, "vector", TY_CONFIG)
    build_s = time.perf_counter() - t
    b = client.stats()
    coding = coder.load(root, TY_CODER)
    if coding["column"] != pa.list_(pa.float32(), D):
        raise AssertionError(f"the coder reports the column {coding['column']}, not the dequantized view")
    cells_read = client.read_table(TY_Q8, select=["__CODED_ID__"], coding=TY_CODER, column="vector").read_all()
    cell_ids = np.array(cells_read.column(0).to_numpy())
    if cell_ids.shape[0] != ROWS or cell_ids.min() < 0 or cell_ids.max() >= TY_CELLS:
        raise AssertionError(f"coded read: {cell_ids.shape[0]} ids in [{cell_ids.min()}, {cell_ids.max()}]")
    name, qn, probes = TY_PROBED
    probed_queries = make_queries(vectors, qn, seed=1301)
    kw = dict(metric="l2", maxval=IVF_K, coding=TY_CODER, probes=probes)
    probed, client_ms, server_ms, _, _ = timed_search(client, name, probed_queries, kw,
                                                      launch_rises(ALL_LAUNCH_KEYS, 0), TY_WARM_REPS, TY_Q8)
    c = client.stats()
    routes = stats_delta(b, c, IVF_ROUTES.values())
    if sum(routes.values()) != 1 + TY_WARM_REPS:
        raise AssertionError(f"{name}: the probed routes moved by {routes}")
    emit({"phase": "typed_ivf", "table": TY_Q8, "client_s": build_s,
          "make_coder_s": b["make-coder.seconds"] - a.get("make-coder.seconds", 0),
          "make_index_s": b["make-index.seconds"] - a.get("make-index.seconds", 0), "config": TY_CONFIG,
          "search": name, "q": qn, "probes": probes, "routes": routes, "first_client_ms": client_ms[0],
          "warm_client_median_ms": float(np.median(client_ms[1:])),
          "warm_server_median_ms": float(np.median(server_ms[1:])), "device": kind, "nvidia_smi": smi})

    # (d) an append quantized with the table's type; a search finds its rows
    new_vecs, new_ids, new_tags = appended_rows(TY_APPEND_ROWS, D, ROWS, [], seed=1302)
    new_col = types.QUInt8TensorArray.from_numpy(new_vecs, like=typ)
    new_codes = ingest.fixed_size_list_to_numpy(new_col.storage)
    batch = pa.record_batch([pa.array(new_ids), new_col, pa.array(new_tags)],
                            schema=pa.schema([pa.field("id", pa.int64()), pa.field("vector", typ),
                                              pa.field("tag", pa.int32())]))
    a = client.stats()
    client.append_table(TY_Q8, pa.RecordBatchReader.from_batches(batch.schema, iter([batch])))
    deq_new = types.quint8.dequantize_np(new_codes, typ.scale, typ.shift)
    picked = np.linspace(0, TY_APPEND_ROWS - 1, 8).astype(np.int64)
    rng = np.random.default_rng(1303)
    append_queries = deq_new[picked] + 0.01 * rng.standard_normal((8, D), dtype=np.float32)
    b = client.stats()
    appended, row = mutation_search(client, "q8_append_q8_cosine", TY_Q8, append_queries,
                                    dict(metric="cosine", maxval=10),
                                    {"cache.incremental_refreshes": 1, **launch_rises(("kernel.stream",), 1)})
    found = np.asarray(appended.column("id")).reshape(8, 10)[:, 0]
    if not np.array_equal(found, new_ids[picked]):
        raise AssertionError(f"the appended rows were not found first: {found} vs {new_ids[picked]}")
    emit({"phase": "typed_append", "rows": TY_APPEND_ROWS, "put_s": b.get("put.seconds", 0) - a.get("put.seconds", 0),
          **row, "device": kind, "nvidia_smi": smi})

    # (e) items_t against items: the same fp32 bytes, the same answer
    for spec, qnp in zip(SEARCHES, queries):
        name, qn, metric, k, precision, filtered, flat = spec
        if name not in TY_T_SEARCHES:
            continue
        kw = dict(metric=metric, maxval=k, precision=precision,
                  filter=(expr.field("tag") < 50) if filtered else None)
        rises = launch_rises((ROUTES[precision], f"kernel.{kernels.kernel_for(scan_dtypes[precision], qn, D)}"), 1)
        got, t_ms, t_server, _, _ = timed_search(client, "t_" + name, qnp, kw, rises, TY_WARM_REPS, TY_T)
        want = timed_search(client, name, qnp, kw, rises, 0)[0]
        same_ids = got.column("id").equals(want.column("id"))
        same_d = np.array_equal(np.asarray(got.column("__DISTANCE__")).view(np.uint32),
                                np.asarray(want.column("__DISTANCE__")).view(np.uint32))
        same_v = np.array_equal(ingest.fixed_size_list_to_numpy(types.typed_column(got, "vector")),
                                ingest.fixed_size_list_to_numpy(want.column("vector")))
        if not (same_ids and same_d and same_v):
            raise AssertionError(f"t_{name}: items_t differs from items (ids {same_ids}, distances {same_d}, "
                                 f"vectors {same_v})")
        if types.logical_vector(got.schema.field("vector")).kind != "tensor":
            raise AssertionError(f"t_{name}: the vector column came back as {got.schema.field('vector')}")
        emit({"phase": "typed_search", "table": TY_T, "search": name, "q": qn, "k": k, "bit_equal_to_items": True,
              "first_client_ms": t_ms[0], "warm_client_median_ms": float(np.median(t_ms[1:])),
              "warm_server_median_ms": float(np.median(t_server[1:])), "device": kind, "nvidia_smi": smi})
    after = launches(client)
    path = {k: v - start[k] for k, v in after.items()}
    emit({"phase": "typed_served", "launches": path})
    return {"type": typ, "codes": codes, "deq": deq, "results": results, "read": (read_queries, read),
            "probed": (probed_queries, probed, cell_ids, coding["tensor"]),
            "append": (new_ids, new_tags, deq_new, append_queries, appended), "launches": path}


def phase_typed_checks(ty: dict, queries, tags, smi: str, kind: str) -> list[dict]:
    """Phase 13 after the server: every items_q8 answer against the float64
    oracle over the numpy-dequantized rows (the appended ones included,
    masked out before the append), by phase 4's rule; then the card's
    dequantization (codes up, ``quint8.dequantize_torch``) against numpy,
    bit for bit, timed beside an upload of the fp32 matrix."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch import types
    from fenix_tpu_torch.io import ingest

    new_ids, new_tags, deq_new, append_queries, appended = ty["append"]
    oracle = Oracle([ty["deq"], deq_new], DEVICE)
    total = ROWS + TY_APPEND_ROWS
    before_append = torch.zeros(total, dtype=torch.bool, device=DEVICE)
    before_append[:ROWS] = True
    tags_dev = torch.from_numpy(np.concatenate([tags, new_tags])).to(DEVICE)
    out = []
    for spec, qnp in zip(SEARCHES, queries):
        mask = before_append & (tags_dev < 50) if spec[5] else before_append
        out.append({"search": "q8_" + spec[0], **check_search(oracle, spec, qnp, ty["results"][spec[0]], mask)})
    read_queries, read = ty["read"]
    want_rows = np.flatnonzero(tags == TY_READ[3][1])
    out.append(check_selection(oracle, "q8_" + TY_READ[0], TY_READ[2], read_queries, read, lambda qi: want_rows))
    probed_queries, probed, cell_ids, codebooks = ty["probed"]
    name, qn, probes = TY_PROBED
    probe_cells = server_cells(probed_queries, codebooks, "l2", probes, f"typed.{name}")
    in_cells = probe_mask(torch.from_numpy(cell_ids).to(DEVICE), probe_cells, None, TY_CELLS)

    def probed_mask(s, e):  # the appended rows came after the search
        m = in_cells(s, e)
        return torch.cat([m, m.new_zeros((m.shape[0], TY_APPEND_ROWS))], dim=1)

    ids, dist = split_result(probed, qn, IVF_K)
    out.append({"search": name, **check_ids(oracle, name, "l2", IVF_K, "fp32", probed_queries, ids, dist,
                                            probed_mask, require_ties=False)})
    ids, dist = split_result(appended, 8, 10)
    out.append({"search": "q8_append_q8_cosine", **check_ids(oracle, "q8_append_q8_cosine", "cosine", 10, "fp32",
                                                             append_queries, ids, dist, None, require_ties=False)})
    for r in out:
        emit({"phase": "typed_oracle", **r})
    del oracle
    torch.cuda.empty_cache()

    # the card's dequantization: the same bits as numpy's
    typ, codes = ty["type"], ty["codes"]
    col = pa.chunked_array([pa.ExtensionArray.from_storage(typ, pa.FixedSizeListArray.from_arrays(
        pa.array(codes[s : s + BATCH_ROWS].reshape(-1)), D)) for s in range(0, ROWS, BATCH_ROWS)], type=typ)
    times = {}
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    for how, src in (("codes_dequantized_on_card", col), ("fp32_upload", ty["deq"])):
        sync()
        t = time.perf_counter()
        m = ingest.to_device_matrix(src, block=1024, device=DEVICE)
        sync()
        times[how] = (time.perf_counter() - t) * 1e3
        if how == "codes_dequantized_on_card":
            on_card = m
        else:
            equal = bool(torch.equal(on_card.data[:ROWS].view(torch.int32), m.data[:ROWS].view(torch.int32)))
        del m
    del on_card
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("the card's dequantization differs from numpy's")
    row = {"phase": "typed_dequantize", "rows": ROWS, "bit_equal": equal, "codes_bytes": int(codes.nbytes),
           "fp32_bytes": int(ty["deq"].nbytes), **{f"{k}_ms": v for k, v in times.items()},
           "device": kind, "nvidia_smi": smi}
    emit(row)
    return out


# -- phase 14: tracing, replay and the catalog --------------------------------


def trace_summary(path: str) -> dict:
    """One request's torch.profiler Chrome trace: the wall time of its
    fenix.rpc.search span, the union of the device's kernel, copy and
    memset intervals inside it, the idle share 1 - busy / wall, the other
    spans' summed durations and the device operations taking most time.
    A trace without kernel events on a card is refused."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if isinstance(e, dict) and e.get("ph") == "X"]
    rpc = [e for e in events if e.get("name") == "fenix.rpc.search" and e.get("cat") == "user_annotation"]
    if len(rpc) != 1:
        raise AssertionError(f"{path}: {len(rpc)} fenix.rpc.search spans")
    lo = float(rpc[0]["ts"])
    hi = lo + float(rpc[0]["dur"])
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in TR_SPANS[1:]:
            spans[e["name"]] = spans.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    device = sorted((max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])), e)
                    for e in events if e.get("cat") in TR_DEVICE_CATS)
    if DEVICE == "cuda" and not any(e.get("cat") == "kernel" for _, _, e in device):
        raise AssertionError(f"{path}: no CUDA kernel events in the trace")
    busy, end, by_op = 0.0, lo, {}
    for s, e, ev in device:
        if e > s:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        by_op[ev["name"]] = by_op.get(ev["name"], 0.0) + float(ev["dur"]) / 1e3
    wall = hi - lo
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TR_TOP_OPS]
    return {"wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall if wall else None,
            "device_events": len(device), "kernels": sum(e.get("cat") == "kernel" for _, _, e in device),
            "spans_ms": spans, "top_device_ops_ms": [[n, v] for n, v in top]}


def tracing_requests(expr, vectors, queries) -> list:
    """(name, target, search options) of each request kind phase 14
    traces, with the queries of the phase each comes from."""
    flat = queries[0][0]
    q1024 = queries[[s[0] for s in SEARCHES].index("q1024_l2_k100_filtered")]
    ivf_i = [s[0] for s in IVF_SEARCHES].index("ivf_q1024_p64")
    ivf_q = make_queries(vectors, IVF_SEARCHES[ivf_i][1], seed=200 + ivf_i)
    read_q = make_queries(vectors, TR_READ[1], seed=300)
    config3 = AN_REQUESTS[0]
    c3_q = make_queries(vectors, config3[1], seed=config3[10])
    return [
        ("q1_cosine_k10", flat, dict(metric="cosine", maxval=10)),
        ("q1024_l2_k100_filtered", q1024, dict(metric="l2", maxval=100, filter=expr.field("tag") < 50)),
        ("ivf_q1024_p64", ivf_q, dict(maxval=IVF_K, coding=IVF_CODER, probes=64)),
        (TR_READ[0], read_q, dict(metric=TR_READ[2], maxval=None, select=["id"], filter=tag_filter(expr, TR_READ[3]))),
        ("config3_join_sum_weight", c3_q[0], dict(metric=config3[2], maxval=config3[3], join=config3[7],
                                                  aggregate=config3[8])),
    ]


def phase_tracing_serve(client, expr, vectors, queries, trace_dir: str, smi: str, kind: str) -> dict:
    """Phase 14 on a server started with FENIX_TRACE_DIR and
    FENIX_QUERY_LOG: the catalog (list_flights names every table,
    get_flight_info gives items' schema and the row count a read gives),
    then each request kind once to warm up and once traced, its trace
    parsed (trace_summary). Returns the printed rows."""
    import pyarrow as pa
    import pyarrow.flight as fl

    names = sorted(i.descriptor.path[0].decode() for i in client.conn.list_flights())
    if names != sorted(client.list_tables()):
        raise AssertionError(f"list_flights gave {names}, list-tables {sorted(client.list_tables())}")
    info = client.conn.get_flight_info(fl.FlightDescriptor.for_path("smoke/items"))
    rows = client.read_table("smoke/items", select=["id"]).read_all().num_rows
    schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), D), "tag": pa.int32()})
    if info.total_records != rows or info.schema != schema:
        raise AssertionError(f"get_flight_info: {info.total_records} rows, {info.schema}; a read gives {rows}")
    emit({"phase": "catalog", "tables": names, "items_rows": rows, "items_schema": str(info.schema)})

    out = {}
    for name, target, kw in tracing_requests(expr, vectors, queries):
        client.search(target, "smoke/items", "vector", **kw)  # warm-up (traced too; its trace is not read)
        seen = set(os.listdir(trace_dir))
        t = time.perf_counter()
        client.search(target, "smoke/items", "vector", **kw)
        client_ms = (time.perf_counter() - t) * 1e3
        new = sorted(set(os.listdir(trace_dir)) - seen)
        if len(new) != 1:
            raise AssertionError(f"{name}: {len(new)} new traces")
        row = {"phase": "trace", "request": name, "client_ms": client_ms, "trace": new[0],
               "trace_bytes": os.path.getsize(os.path.join(trace_dir, new[0])),
               **trace_summary(os.path.join(trace_dir, new[0])), "device": kind, "nvidia_smi": smi}
        emit(row)
        out[name] = row
    return out


def phase_tracing_after(root: str, log_path: str, smi: str, kind: str) -> dict:
    """Phase 14 after its server: the query log replayed in this process on
    DEVICE (every logged search must match its digest)."""
    from fenix_tpu_torch.engine import executor
    from fenix_tpu_torch.utils import replay

    t = time.perf_counter()
    stats = replay.replay(log_path, root, device=DEVICE)
    replay_s = time.perf_counter() - t
    logged = sum(1 for _ in replay.load(log_path))
    if stats != {"total": logged, "matched": logged, "mismatched": 0} or not logged:
        raise AssertionError(f"replay of {logged} logged searches: {stats}")
    executor.get_cache(root, DEVICE).invalidate()
    emit({"phase": "replay", **stats, "seconds": replay_s, "device": kind, "nvidia_smi": smi})
    return {"replay": stats}


# -- phase 15: the serving mesh ------------------------------------------------


def mesh_for_run():
    """The phase's mesh: every card when there are two or more (the
    serving mesh), else MESH_SHARDS shards on the one card. Returns the
    mesh and its ``{"cards", "shards"}``."""
    import torch

    from fenix_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if cards >= 2:
        return make_mesh(cards), {"cards": cards, "shards": cards}
    device = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    return make_mesh(devices=[device] * MESH_SHARDS), {"cards": 1 if DEVICE == "cuda" else 0, "shards": MESH_SHARDS}


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def in_process(fn, reps: int) -> tuple:
    """``fn()`` once (the first call) and ``reps`` times more, each on the
    host clock up to the result on the host: ``(result, first_s, warm_ms)``."""
    t = time.perf_counter()
    result = fn()
    sync()
    first = time.perf_counter() - t
    warm = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        warm.append((time.perf_counter() - t) * 1e3)
    return result, first, warm


def tie_canonical(result, qn: int, k: "int | None" = None):
    """``(ids, dist)`` of a result in (query, distance, id) order: rows of
    one query whose fp32 distances tie put in id order (the mesh merges by
    (distance, id), one device orders by score)."""
    import numpy as np

    ids = np.asarray(result.column("id"))
    dist = np.asarray(result.column("__DISTANCE__"))
    qid = (result.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in result.column_names
           else np.zeros(ids.shape[0], np.int64))
    order = np.lexsort((ids, dist, qid))
    return ids[order], dist[order], qid[order]


def check_mesh_vs_single(name: str, got, want, qn: int) -> dict:
    """The mesh's answer against the single device's on the same table:
    the same ids per query with fp32 distance ties in id order, every
    distance within 1e-5 * max(1, d)."""
    import numpy as np

    gi, gd, gq = tie_canonical(got, qn)
    wi, wd, wq = tie_canonical(want, qn)
    if not (np.array_equal(gq, wq) and np.array_equal(gi, wi)):
        bad = int((gi != wi).sum()) if gi.shape == wi.shape else -1
        raise AssertionError(f"{name}: mesh ids differ from the single device's at {bad} positions")
    err = np.abs(gd - wd) / np.maximum(1.0, np.abs(wd))
    if err.size and err.max() > 1e-5:
        raise AssertionError(f"{name}: mesh distances off the single device's by {err.max()} relative")
    raw = np.asarray(got.column("id")), np.asarray(want.column("id"))
    return {"ids_equal": True, "ids_equal_unsorted": bool(np.array_equal(*raw)),
            "max_rel_dist_diff": float(err.max()) if err.size else 0.0}


def mesh_requests(expr, vectors, queries) -> list[dict]:
    """Phase 15 (a)'s requests: phase 3's five searches, the Q=1024 one
    again on the all-gather route, MESH_READ, and MESH_IVF on phase 7's
    coder. Each: name, queries, target, the search's keywords, the
    FENIX_RING value, the route counter a call must move, and its check."""
    reqs = []
    for spec, qnp in zip(SEARCHES, queries):
        name, qn, metric, k, precision, filtered, flat = spec
        kw = dict(metric=metric, maxval=k, precision=precision,
                  filter=(expr.field("tag") < 50) if filtered else None)
        ring = "auto"
        counter = "search.mesh_ring" if qn >= 512 else "search.mesh_gather"
        reqs.append({"name": name, "q": qn, "queries": qnp, "target": qnp[0] if flat else qnp, "kw": kw,
                     "ring": ring, "counter": counter, "check": ("search", spec)})
        if qn >= 512:
            reqs.append({**reqs[-1], "name": f"{name}_gather", "ring": "off", "counter": "search.mesh_gather"})
    name, qn, metric, pred, _ = MESH_READ
    qnp = make_queries(vectors, qn, seed=1500)
    reqs.append({"name": name, "q": qn, "queries": qnp, "target": qnp, "ring": "auto", "counter": "search.nomax_selected",
                 "kw": dict(metric=metric, maxval=None, select=["id"], filter=tag_filter(expr, pred)),
                 "check": ("read", pred)})
    for i, (name, qn, probes, filtered, route) in enumerate(MESH_IVF):
        qnp = make_queries(vectors, qn, seed=1510 + i)
        reqs.append({"name": name, "q": qn, "queries": qnp, "target": qnp, "ring": "auto",
                     "counter": tuple(IVF_ROUTES.values()), "route": route, "check": ("ivf", probes, filtered),
                     "kw": dict(metric="l2", maxval=IVF_K, coding=IVF_CODER, probes=probes,
                                filter=(expr.field("tag") < 50) if filtered else None)})
    return reqs


def run_requests(executor, cache, reqs, reps: int, source="smoke/items") -> tuple[dict, dict]:
    """Each request through ``executor.execute_search`` (the entry Flight
    calls) over ``source``: ``{name: (result, first_s, warm_ms)}``, and per
    request the rise of each of its route counters (an IVF request names
    both IVF routes; every call moves one of them)."""
    from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

    out, routes = {}, {}
    for r in reqs:
        os.environ["FENIX_RING"] = r["ring"]
        req = executor.SearchRequest(source=source, column="vector", target=r["target"], **r["kw"])
        counters = r["counter"] if isinstance(r["counter"], tuple) else (r["counter"],)
        before = METRICS.snapshot()
        out[r["name"]] = in_process(lambda: executor.execute_search(cache, req), reps)
        after = METRICS.snapshot()
        routes[r["name"]] = {c: after.get(c, 0) - before.get(c, 0) for c in counters}
    os.environ.pop("FENIX_RING", None)
    return out, routes


def mesh_oracle_checks(oracle, r: dict, result, codes, codebooks, tags) -> dict:
    """A phase-15 answer against the float64 oracle, as phases 4, 7 and 8
    hold theirs."""
    import numpy as np
    import torch

    kind = r["check"][0]
    if kind == "search":
        spec = r["check"][1]
        mask = torch.from_numpy(tags < 50).to(oracle.device) if spec[5] else None
        return check_search(oracle, (r["name"], *spec[1:]), r["queries"], result, mask)
    if kind == "read":
        rows = np.flatnonzero(tag_mask(tags, r["check"][1]))
        return check_selection(oracle, r["name"], r["kw"]["metric"], r["queries"], result, lambda qi: rows)
    _, probes, filtered = r["check"]
    qn = r["q"]
    ids, dist = split_result(result, qn, IVF_K)
    sel = np.arange(qn) if qn <= IVF_CHECKED else np.linspace(0, qn - 1, IVF_CHECKED).astype(np.int64)
    probe_cells = server_cells(r["queries"], codebooks, "l2", probes, f"mesh.{r['name']}")
    codes_dev = torch.from_numpy(codes).to(oracle.device)
    tags_dev = torch.from_numpy(tags).to(oracle.device) if filtered else None
    return check_ids(oracle, r["name"], "l2", IVF_K, "fp32", np.ascontiguousarray(r["queries"][sel]), ids[sel],
                     dist[sel], probe_mask(codes_dev, probe_cells[sel], tags_dev), require_ties=False)


def mesh_shard_inputs(topk2, cache, r: dict, n_shards: int):
    """The phase-1 kernel's inputs as shard 0 of the mesh gets them for
    request ``r``: its rows of the sharded matrix (or scan copy) and aux,
    the filter folded in, and its queries (a ring block of Q / S at the
    ring's sizes)."""
    import torch

    from fenix_tpu_torch.ops.distance import NEG_INF

    kw = r["kw"]
    metric, precision = kw["metric"], kw["precision"]
    col = cache.sharded_matrix("smoke/items", "vector")
    v = col.data.shards[0]
    mul, add = (a.shards[0] for a in cache.sharded_aux("smoke/items", "vector", metric))
    if kw["filter"] is not None:
        add = torch.where(cache.device_filter_mask("smoke/items", kw["filter"], sharded=True).shards[0], add, NEG_INF)
    q = r["target"].reshape(-1, v.shape[1])
    if r["ring"] == "auto" and q.shape[0] >= 512:
        q = q[: -(-q.shape[0] // n_shards)]  # a ring block
    qp = topk2.prepare_queries(torch.from_numpy(q).to(v.device), metric).contiguous()
    bucket = topk2.bucket_for(qp.shape[0], v.shape[0])
    if precision == "int8":
        v8, sv = (a.data.shards[0] for a in cache.matrix_int8("smoke/items", "vector", sharded=True))
        q8, inv_sq = topk2.quantize_queries_int8(qp)
        return (q8, v8, mul * sv, add, bucket, inv_sq)
    if precision == "bf16":
        v16 = cache.matrix_bf16("smoke/items", "vector", sharded=True).data.shards[0]
        return (qp.to(torch.bfloat16), v16, mul, add, bucket, None)
    return (qp, v, mul, add, bucket, None)


def train_sharded_check(kmeans, psearch, mesh, vectors) -> dict:
    """kmeans.train_sharded on the mesh against the same function over S
    CPU shards, same seed, at MESH_TRAIN_CHECK's size (the CPU cannot run
    IVF16384's): codebooks within 1e-5 of the largest entry (fp32 sums in
    another order; the card's index_add_ order is not fixed)."""
    import numpy as np

    from fenix_tpu_torch.parallel.mesh import make_mesh

    rows, cfg = MESH_TRAIN_CHECK["rows"], MESH_TRAIN_CHECK["config"]
    data = np.ascontiguousarray(vectors[:rows])
    kw = dict(num_codebooks=cfg["num_codebooks"], codebook_size=cfg["codebook_size"], batch_size=cfg["batch_size"],
              num_epochs=cfg["num_epochs"], metric=cfg["metric"])
    corpus, _ = psearch.shard_corpus(mesh, data)
    t = time.perf_counter()
    got = kmeans.train_sharded(mesh, corpus, rows, 0, **kw).cpu().numpy()
    card_s = time.perf_counter() - t
    cpu_mesh = make_mesh(devices=["cpu"] * mesh.size)
    t = time.perf_counter()
    want = kmeans.train_sharded(cpu_mesh, psearch.shard_corpus(cpu_mesh, data)[0], rows, 0, **kw).numpy()
    cpu_s = time.perf_counter() - t
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if err > 1e-5:
        raise AssertionError(f"train_sharded on the mesh off the CPU's by {err} of the largest entry")
    return {"rows": rows, "config": cfg, "shards": mesh.size, "max_err_of_largest": err, "card_s": card_s,
            "cpu_s": cpu_s}


def merge_timing(psearch, mesh, q: int, k: int) -> float:
    """The all-gather merge alone at ``[Q, k]`` candidates a shard (card
    clock)."""
    import torch

    dists = [torch.sort(torch.rand((q, k), device=d), dim=1).values for d in mesh.devices]
    ids = [torch.randint(0, 1 << 30, (q, k), device=d) for d in mesh.devices]
    return time_ms(lambda: psearch.merge_candidates(mesh, dists, ids, k), TIMING_REPS)


def per_card_designs(kernels, topk2) -> list[dict]:
    """Each kernel design launched on each card against its plain version
    (the launch shape and shared-memory cap are kept per card)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(15)
    out = []
    for card in range(torch.cuda.device_count()):
        dev = torch.device("cuda", card)
        for d, designs in ((128, ("stream", "tiled", "tensor_int8", "generic_int8", "tensor_bf16")),
                           (100, ("generic_int8", "generic_bf16"))):
            v = torch.from_numpy(rng.standard_normal((1 << 16, d), dtype=np.float32)).to(dev)
            mul = torch.ones(v.shape[0], device=dev)
            add = torch.from_numpy(rng.standard_normal(v.shape[0]).astype(np.float32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((64, d), dtype=np.float32)).to(dev)
            v8, sv = topk2.quantize_corpus_int8(v)
            q8, inv_sq = topk2.quantize_queries_int8(q)
            for design in designs:
                if "int8" in design:
                    args = (q8, v8, mul * sv, add, 32, inv_sq)
                elif design in BF16_DESIGNS:
                    args = (q.bfloat16(), v.bfloat16(), mul, add, 32, None)
                else:
                    args = (q, v, mul, add, 32, None)
                err, _ = check_kernel(kernels, *args, design)
                out.append({"card": card, "d": d, "kernel": design, "max_abs_err": err})
    return out


def phase_mesh(kernels, topk2, expr, vectors, ids_np, tags, queries, latencies, smi: str, kind: str,
               with_shuffle: bool = False) -> dict:
    """Phase 15 (a), (c) and (d): the serving mesh over its own root of
    phase 3's rows (see the module docstring), then, ``with_shuffle``,
    phase 16 on the same mesh and root. Returns the mesh paths' launches
    and the kernel rows at the shard shapes."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch import coder
    from fenix_tpu_torch import index as index_mod
    from fenix_tpu_torch.engine import executor
    from fenix_tpu_torch.engine.session import DeviceCache
    from fenix_tpu_torch.io import arrow, ingest, table
    from fenix_tpu_torch.ops import kmeans
    from fenix_tpu_torch.parallel import search as psearch

    mesh, shape = mesh_for_run()
    emit({"phase": "mesh", "mesh": shape, "devices": [str(d) for d in mesh.devices], "device": kind,
          "nvidia_smi": smi})
    work = os.path.join(HERE, "build", "chip_smoke", f"mesh-{os.getpid()}")
    root = os.path.join(work, "root")
    os.makedirs(work, exist_ok=True)
    try:
        t = time.perf_counter()
        schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), vectors.shape[1]), "tag": pa.int32()})
        table.make(root, "smoke/items", pa.RecordBatchReader.from_batches(schema, (
            pa.record_batch([pa.array(ids_np[s : s + BATCH_ROWS]),
                             ingest.numpy_to_fixed_size_list(vectors[s : s + BATCH_ROWS], pa.float32()),
                             pa.array(tags[s : s + BATCH_ROWS])], schema=schema)
            for s in range(0, vectors.shape[0], BATCH_ROWS))))
        put_s = time.perf_counter() - t
        # make-coder on the mesh: kmeans.train_sharded, IVF16384's config, seed 0
        t = time.perf_counter()
        coder.make(root, IVF_CODER, "smoke/items", "vector", IVF_CONFIG, seed=0, device=DEVICE, mesh=mesh)
        sync()
        train_s = time.perf_counter() - t
        t = time.perf_counter()
        index_mod.make(root, IVF_CODER, "smoke/items", "vector", device=DEVICE)
        index_s = time.perf_counter() - t
        codes = np.array(arrow.load(index_mod.path_of(root, IVF_CODER, "smoke/items", "vector"))
                         .column(index_mod.CODE_COL).to_numpy())
        codebooks = coder.load(root, IVF_CODER)["tensor"]
        emit({"phase": "mesh_root", "rows": int(vectors.shape[0]), "put_s": put_s, "train_sharded_s": train_s,
              "make_index_s": index_s, "coder": IVF_CONFIG, "seed": 0, "mesh": shape, "device": kind,
              "nvidia_smi": smi})

        reqs = mesh_requests(expr, vectors, queries)
        batch_q = make_queries(vectors, MESH_BATCH, seed=1520)
        batch_reqs = [executor.SearchRequest("smoke/items", "vector", batch_q[i], metric="cosine", maxval=10)
                      for i in range(MESH_BATCH)]

        # the single device first, on the same root
        single = DeviceCache(root, device=DEVICE, mesh=None)
        solo, _ = run_requests(executor, single, reqs, MESH_WARM_REPS)
        solo_batch = [executor.execute_search(single, r) for r in batch_reqs]
        del single
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

        # the mesh path: every launch count 0 just before it, read just after
        for counts in (kernels.LAUNCHES, kernels.DEVICE_LAUNCHES):
            for key in counts:
                counts[key] = 0
        meshed = DeviceCache(root, device=DEVICE, mesh=mesh)
        got, routes = run_requests(executor, meshed, reqs, MESH_WARM_REPS)
        t = time.perf_counter()
        batched = executor.execute_search_batched(meshed, batch_reqs)
        batch_ms = (time.perf_counter() - t) * 1e3
        alone = [executor.execute_search(meshed, r) for r in batch_reqs]
        sync()
        mesh_launches = {k.removeprefix("bucket_scores."): v for k, v in kernels.LAUNCHES.items()}
        card_launches = dict(kernels.DEVICE_LAUNCHES)

        rows = {}
        for r in reqs:
            if sum(routes[r["name"]].values()) != MESH_WARM_REPS + 1 or (
                    not isinstance(r["counter"], tuple) and routes[r["name"]][r["counter"]] != MESH_WARM_REPS + 1):
                raise AssertionError(f"{r['name']}: route counters moved {routes[r['name']]} in "
                                     f"{MESH_WARM_REPS + 1} calls")
            result, first, warm = got[r["name"]]
            s_result, s_first, s_warm = solo[r["name"]]
            row = {"phase": "mesh_search", "search": r["name"], "q": r["q"], "ring": r["ring"],
                   "mesh_first_s": first, "mesh_warm_median_ms": float(np.median(warm)), "mesh_warm_ms": warm,
                   "single_first_s": s_first, "single_warm_median_ms": float(np.median(s_warm)),
                   "phase3_client_median_ms": float(np.median(latencies[r["name"]])) if r["name"] in latencies
                   else None, "routes": routes[r["name"]], "clock": "host, in process", "mesh": shape,
                   "device": kind, "nvidia_smi": smi}
            row.update(check_mesh_vs_single(r["name"], result, s_result, r["q"]))
            rows[r["name"]] = row
        ring, gather = (got[f"{SEARCHES[2][0]}{s}"][0] for s in ("", "_gather"))
        if not (ring.column("id").equals(gather.column("id")) and ring.column("__DISTANCE__").equals(
                gather.column("__DISTANCE__"))):
            raise AssertionError("the ring and the all-gather route answer differently at Q=1024")
        for i, (b, a, s) in enumerate(zip(batched, alone, solo_batch)):
            if not b.equals(a):
                raise AssertionError(f"batched request {i} differs from its solo mesh answer")
            check_mesh_vs_single(f"batched_{i}", b, s, 1)
        emit({"phase": "mesh_batched", "requests": MESH_BATCH, "batch_ms": batch_ms, "mesh": shape,
              "device": kind, "nvidia_smi": smi})

        # (d) joins and aggregates on the mesh, both attribute routes
        t = time.perf_counter()
        an = mesh_analytics(expr, executor, DeviceCache, meshed, mesh, shape, root, vectors, smi, kind)
        emit({"phase": "mesh_analytics_done", "seconds": time.perf_counter() - t})

        # (c) several cards: a Flight server with FENIX_MESH=auto, each card's launches
        served = None
        if shape["cards"] >= 2:
            served = mesh_server_checks(kernels, topk2, expr, root, reqs, got, an, vectors, smi, kind)

        # the kernels at the shard shapes, the merge, ring against all-gather
        compares = []
        for r in reqs:
            if r["check"][0] != "search":
                continue
            inputs = mesh_shard_inputs(topk2, meshed, r, mesh.size)
            c = compare(kernels, *inputs)
            compares.append({"search": f"mesh_{r['name']}", "route": ROUTES[r["kw"]["precision"]],
                             "q": int(inputs[0].shape[0]), "n": int(inputs[1].shape[0]), "d": int(inputs[1].shape[1]),
                             "bucket": inputs[4], "shard_of": shape, **c})
            emit({"phase": "kernel_vs_plain_mesh_path", **compares[-1], "device": kind, "nvidia_smi": smi})
            del inputs
        timing = {"phase": "mesh_timing", "merge_ms_q1024_k100": merge_timing(psearch, mesh, 1024, 100),
                  "ring_warm_median_ms": rows[SEARCHES[2][0]]["mesh_warm_median_ms"],
                  "gather_warm_median_ms": rows[f"{SEARCHES[2][0]}_gather"]["mesh_warm_median_ms"],
                  "clock": "card events (merge), host",
                  "mesh": shape, "device": kind, "nvidia_smi": smi}
        emit(timing)
        for row in rows.values():
            emit(row)

        # the mutations: an append and a delete, each refreshed on the mesh
        live = Live(vectors, ids_np, tags)
        mutations = mesh_mutations(expr, executor, index_mod, table, DeviceCache, meshed, mesh, root, live, reqs,
                                   smi, kind)
        del meshed
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

        train_check = train_sharded_check(kmeans, psearch, mesh, vectors)
        emit({"phase": "mesh_train_sharded", "ivf16384_s": train_s, **train_check, "device": kind, "nvidia_smi": smi})

        oracle = Oracle(vectors, DEVICE)
        for r in reqs:
            emit({"phase": "mesh_oracle", "search": r["name"],
                  **mesh_oracle_checks(oracle, r, got[r["name"]][0], codes, codebooks, tags)})
        t = time.perf_counter()
        for route, results in an["results"].items():  # (d) against phase 11's oracles
            phase_analytics_checks(oracle, tags, {"codes": codes, "codebooks": codebooks},
                                   {"results": results, "attrs": an["attrs"], "dup": an["dup"]},
                                   label=f"mesh_analytics_oracle_{route}")
        emit({"phase": "mesh_analytics_oracle_done", "seconds": time.perf_counter() - t})
        shuffled = None
        if with_shuffle:
            t = time.perf_counter()
            shuffled = phase_shuffle(mesh, shape, root, live, reqs, vectors, oracle, smi, kind)
            emit({"phase": "shuffle_done", "launches": shuffled["launches"], "seconds": time.perf_counter() - t})
        del oracle
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": mesh_launches, "card_launches": card_launches, "checks": compares, "mesh": shape,
            "served": served, "mutations": mutations, "analytics_launches": an["launches"],
            "analytics_card_launches": an["card_launches"],
            "repartition_launches": shuffled["launches"] if shuffled else None}


def mesh_card_shards(mesh) -> dict:
    """Shards per card index of the mesh (all four on card 0 on one card)."""
    out: dict = {}
    for d in mesh.devices:
        out[d.index] = out.get(d.index, 0) + 1
    return out


def mesh_analytics(expr, executor, DeviceCache, meshed, mesh, shape, root, vectors, smi: str, kind: str) -> dict:
    """Phase 15 (d): BASELINE config 3's joins on the mesh. attrs and
    attrs_dup go into the mesh root in process; each request of AN_REQUESTS
    runs on one device and then on the mesh, with the join as it stands
    (both tables are past FENIX_PART_ATTRS_MIN: the partitioned route,
    join.partitioned one rise a call) and with "partitioned": false (the
    replicated route), one cold and MESH_WARM_REPS warm calls each. Every
    count is 0 just before the mesh calls and read just after; each call
    launches its design once per shard and nothing else. Each mesh answer
    equals one device's: group keys equal, integer aggregates equal and
    int64, float sums and means within 1e-5 * sum |v| of their group (of
    the numpy oracle's values), min and max equal; lookup and inner rows
    equal with fp32 distance ties in id order. The plain mesh search of
    each request is returned for phase 11's oracles."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch.engine import analytics
    from fenix_tpu_torch.io import table
    from fenix_tpu_torch.ops import kernels
    from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

    attrs, dup = analytics_tables()
    for name, cols in (("attrs", attrs), ("dup", dup)):
        schema = pa.schema({k: pa.from_numpy_dtype(v.dtype) for k, v in cols.items()})
        rows = len(next(iter(cols.values())))
        t = time.perf_counter()
        table.make(root, "attrs" if name == "attrs" else "attrs_dup", pa.RecordBatchReader.from_batches(schema, (
            pa.record_batch([pa.array(v[s : s + AN_BATCH_ROWS]) for v in cols.values()], schema=schema)
            for s in range(0, rows, AN_BATCH_ROWS))))
        emit({"phase": "mesh_analytics_put", "table": name, "rows": rows, "seconds": time.perf_counter() - t})

    scan_dtypes = {"fp32": torch.float32, "int8": torch.int8}
    reqs = []
    for name, qn, metric, k, precision, filtered, probes, join, aggregate, route, seed in AN_REQUESTS:
        queries = make_queries(vectors, qn, seed=seed)
        kw = dict(metric=metric, maxval=k, precision=precision,
                  filter=(expr.field("tag") < 50) if filtered else None)
        if probes is not None:
            kw.update(coding=IVF_CODER, probes=probes)
        req = executor.SearchRequest("smoke/items", "vector", queries[0] if qn == 1 else queries, **kw)
        design = None if probes is not None else kernels.kernel_for(scan_dtypes[precision], qn, D)
        reqs.append({"name": name, "q": qn, "queries": queries, "req": req, "join": join, "aggregate": aggregate,
                     "route": route, "design": design})

    def plain_req(r: dict):
        return executor.SearchRequest("smoke/items", "vector", r["req"].target, **{k: getattr(r["req"], k) for k in (
            "metric", "maxval", "precision", "filter", "coding", "probes")})

    def call(cache, r: dict, partitioned: "bool | None"):
        join = analytics.JoinSpec.from_dict({**r["join"], "partitioned": partitioned} if partitioned is False
                                            else r["join"])
        agg = analytics.AggregateSpec.from_dict(r["aggregate"]) if r["aggregate"] else None
        return lambda: analytics.execute_search_join(cache, r["req"], join, agg)

    single = DeviceCache(root, device=DEVICE, mesh=None)
    solo = {r["name"]: in_process(call(single, r, None), MESH_WARM_REPS) for r in reqs}
    solo_plain = {r["name"]: executor.execute_search(single, plain_req(r)) for r in reqs}
    del single
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # the mesh analytics path: every launch count 0 just before it, read just after
    for counts in (kernels.LAUNCHES, kernels.DEVICE_LAUNCHES):
        for key in counts:
            counts[key] = 0
    routes = {"partitioned": None, "replicated": False}
    got, rows, shards_on = {}, [], mesh_card_shards(mesh)
    calls = 1 + MESH_WARM_REPS
    for route, partitioned in routes.items():
        for r in reqs:
            m0, d0 = METRICS.snapshot(), dict(kernels.DEVICE_LAUNCHES)
            result, first, warm = in_process(call(meshed, r, partitioned), MESH_WARM_REPS)
            m1, d1 = METRICS.snapshot(), dict(kernels.DEVICE_LAUNCHES)
            moved = {c: m1.get(c, 0) - m0.get(c, 0) for c in ("join.fused", "join.two_step", "join.inner",
                                                                "join.partitioned", "search.mesh_ring")}
            want = {"join.fused": 0, "join.two_step": 0, "join.inner": 0, r["route"]: calls,
                    "join.partitioned": calls if route == "partitioned" else 0, "search.mesh_ring": 0}
            if moved != want:
                raise AssertionError(f"{route} {r['name']}: counters moved {moved}, expected {want}")
            rises = {key: d1.get(key, 0) - d0.get(key, 0) for key in set(d0) | set(d1)}
            for design in DESIGNS:
                for card, n in shards_on.items():
                    key = f"bucket_scores.kernel.{design}.cuda{card}"
                    expect = calls * n if DEVICE == "cuda" and design == r["design"] else 0
                    if rises.get(key, 0) != expect:
                        raise AssertionError(f"{route} {r['name']}: {key} rose by {rises.get(key, 0)}, expected "
                                             f"{expect} ({calls} calls, {n} shards on the card)")
            got[route, r["name"]] = result
            s_result, s_first, s_warm = solo[r["name"]]
            rows.append({"phase": "mesh_analytics_search", "search": r["name"], "attrs_route": route,
                         "q": r["q"], "join_route": r["route"], "kernel": r["design"],
                         "mesh_first_s": first, "mesh_warm_median_ms": float(np.median(warm)), "mesh_warm_ms": warm,
                         "single_first_s": s_first, "single_warm_median_ms": float(np.median(s_warm)),
                         "first_parted_key_s": m1.get("cache.parted_key_seconds", 0)
                         - m0.get("cache.parted_key_seconds", 0),
                         "first_sorted_key_s": m1.get("cache.sorted_key_seconds", 0)
                         - m0.get("cache.sorted_key_seconds", 0),
                         "launches_per_card_per_call": {k: v / calls for k, v in rises.items() if v},
                         "clock": "host, in process", "mesh": shape, "device": kind, "nvidia_smi": smi})
    sync()
    path = {k.removeprefix("bucket_scores."): v for k, v in kernels.LAUNCHES.items()}
    card_path = dict(kernels.DEVICE_LAUNCHES)

    # the plain mesh search of each request, the input of phase 11's
    # oracles: on the all-gather route, the fused route's merge
    os.environ["FENIX_RING"] = "off"
    plain = {r["name"]: executor.execute_search(meshed, plain_req(r)) for r in reqs}
    os.environ.pop("FENIX_RING")

    # the partial-table merge alone, on the Q=1024 count's partials
    count = next(r for r in reqs if r["name"] == AN_REQUESTS[1][0])  # the Q=1024 count
    captured, merge = [], analytics._merge_parted_tables
    analytics._merge_parted_tables = lambda *a: captured.append(a) or merge(*a)
    try:
        call(meshed, count, None)()
    finally:
        analytics._merge_parted_tables = merge
    merge_ms = host_ms(lambda: merge(*captured[0]))

    for route in routes:
        for r, row in zip(reqs, rows[len(reqs) * list(routes).index(route):]):
            row.update(check_join_vs_single(f"{route} {r['name']}", got[route, r["name"]], solo[r["name"]][0],
                                            r["q"], plain[r["name"]], solo_plain[r["name"]], r, attrs, dup))
            emit(row)
    emit({"phase": "mesh_analytics_timing", "merge_parted_ms_q1024_count": merge_ms,
          "partials": len(captured[0][0]), "groups_per_partial": [int(p[2]) for p in captured[0][0]],
          "clock": "host", "mesh": shape, "device": kind, "nvidia_smi": smi})
    emit({"phase": "mesh_analytics_served", "launches": path, "launches_per_card": card_path, "mesh": shape})
    results = {route: {r["name"]: (r["queries"], plain[r["name"]], got[route, r["name"]]) for r in reqs}
               for route in routes}
    results["single"] = {r["name"]: (r["queries"], solo_plain[r["name"]], solo[r["name"]][0]) for r in reqs}
    return {"launches": path, "card_launches": card_path, "results": results, "attrs": attrs, "dup": dup}


def winner_swaps(name: str, plain, solo_plain, qn: int) -> int:
    """The winners (query, id) of the mesh's plain search that one
    device's lacks. A swap is allowed only at fp32 resolution: the
    swapped winner's distance within NEAR_TIE of its query's last one,
    on both sides (the two searches sum a distance's products in orders
    that may differ by an ulp, so a tie at the k-th place can break
    either way)."""
    import numpy as np

    def pairs(t):
        q = t.column("__QUERY_ID__").to_numpy() if qn > 1 else np.zeros(t.num_rows, np.int64)
        return q * (1 << 32) + np.asarray(t.column("id")), q, np.asarray(t.column("__DISTANCE__"))

    (a, qa, da), (b, qb, db) = pairs(plain), pairs(solo_plain)
    only = [(np.isin(a, b, invert=True), qa, da), (np.isin(b, a, invert=True), qb, db)]
    if only[0][0].sum() != only[1][0].sum():
        raise AssertionError(f"{name}: the mesh and one device return different row counts")
    for extra, q, d in only:
        last = np.full(qn, -np.inf)
        np.maximum.at(last, q, d)
        if (np.abs(d[extra] - last[q[extra]]) > NEAR_TIE * np.maximum(1.0, np.abs(last[q[extra]]))).any():
            raise AssertionError(f"{name}: the mesh's winners differ from one device's past fp32 near ties")
    return int(only[0][0].sum())


def check_join_vs_single(name: str, got, want, qn: int, plain, solo_plain, r: dict, attrs: dict, dup: dict) -> dict:
    """A mesh join answer against one device's (see mesh_analytics). Where
    the two plain searches' winners differ by a near tie at the k-th
    place (winner_swaps), the answers differ by those winners' rows:
    each is then held to phase 11's oracles over its own winners, and
    the swaps are counted."""
    import numpy as np
    import pyarrow as pa

    swaps = winner_swaps(name, plain, solo_plain, qn)
    if swaps:
        return {"winner_swaps": swaps}
    if r["aggregate"] is None:  # lookup or inner rows, fp32 distance ties in id order
        g = np.lexsort((np.asarray(got.column("id")), np.asarray(got.column("__DISTANCE__")),
                        got.column("__QUERY_ID__").to_numpy() if qn > 1 else np.zeros(got.num_rows)))
        w = np.lexsort((np.asarray(want.column("id")), np.asarray(want.column("__DISTANCE__")),
                        want.column("__QUERY_ID__").to_numpy() if qn > 1 else np.zeros(want.num_rows)))
        if got.column_names != want.column_names or got.num_rows != want.num_rows:
            raise AssertionError(f"{name}: mesh rows {got.num_rows} {got.column_names} differ from one device's")
        for col in got.column_names:
            a, b = got.column(col).take(pa.array(g)), want.column(col).take(pa.array(w))
            if col == "__DISTANCE__":
                a, b = a.to_numpy(), b.to_numpy()
                if (np.abs(a - b) > 1e-5 * np.maximum(1.0, np.abs(b))).any():
                    raise AssertionError(f"{name}: mesh distances off one device's")
            elif not a.equals(b):
                raise AssertionError(f"{name}: mesh column {col} differs from one device's")
        return {"rows": got.num_rows, "rows_equal": True, "winner_swaps": 0}
    groups, values = oracle_groups(plain, r["join"], r["aggregate"], attrs, dup)
    keys = got.column("__GROUP__").to_pylist()
    if keys != want.column("__GROUP__").to_pylist():
        raise AssertionError(f"{name}: mesh group keys differ from one device's")
    a, b = got.column("__AGG__").to_numpy(), want.column("__AGG__").to_numpy()
    agg = r["aggregate"]["agg"]
    if pa.types.is_integer(want.schema.field("__AGG__").type):
        if got.schema.field("__AGG__").type != pa.int64() or not np.array_equal(a, b):
            raise AssertionError(f"{name}: mesh integer aggregate differs from one device's")
        return {"groups": len(keys), "aggregates_equal": True, "winner_swaps": 0}
    worst = 0.0
    for slot, key in enumerate(keys):
        if agg in ("min", "max"):
            if a[slot] != b[slot]:
                raise AssertionError(f"{name}: group {key} {agg} {a[slot]} != one device's {b[slot]}")
            continue
        scale = float(np.abs(values[groups == key]).sum())
        if abs(a[slot] - b[slot]) > 1e-5 * scale:
            raise AssertionError(f"{name}: group {key} {agg} off one device's by {abs(a[slot] - b[slot])}")
        worst = max(worst, abs(a[slot] - b[slot]) / max(scale, 1e-30))
    return {"groups": len(keys), "max_rel_diff_of_sum_abs": worst, "winner_swaps": 0}


def mesh_mutations(expr, executor, index_mod, table, DeviceCache, meshed, mesh, root, live, reqs,
                   smi: str, kind: str) -> dict:
    """An append of MUT_APPEND_ROWS rows (row 0 a copy of the Q=8 cosine
    query 0) and a delete of tag == 9, in process as the Flight verbs make
    them: the next mesh search grows the sharded matrix (one incremental
    refresh), then shrinks it by the lineage (one lineage refresh), each
    answer equal to a cold mesh cache's and held to the float64 oracle
    over the live copy."""
    import torch

    cos = next(r for r in reqs if r["name"] == "q8_cosine_k10")
    big = next(r for r in reqs if r["name"] == SEARCHES[2][0])
    rows0 = live.ids.shape[0]
    out = {}
    new = appended_rows(MUT_APPEND_ROWS, live.parts[0].shape[1], rows0, (cos["queries"][0],), seed=650)
    for step, r, rises in (("append", cos, (1, 0)), ("delete_tag_eq_9", big, (0, 1))):
        before = (meshed.incremental_refreshes, meshed.lineage_refreshes)
        t = time.perf_counter()
        if step == "append":
            appended = to_reader(*new).read_all()
            table.append(root, "smoke/items", appended)
            index_mod.extend_for_source(root, "smoke/items", appended, DEVICE)
            live.append(*new)
        else:
            deleted = index_mod.delete_rows(root, "smoke/items", expr.field("tag") == 9)
            if deleted != int((live.tags == 9).sum()):
                raise AssertionError(f"deleted {deleted} rows, the copy {int((live.tags == 9).sum())}")
            live.keep(live.tags != 9)
        mutate_s = time.perf_counter() - t
        os.environ["FENIX_RING"] = "auto"
        req = executor.SearchRequest(source="smoke/items", column="vector", target=r["target"], **r["kw"])
        t = time.perf_counter()
        result = executor.execute_search(meshed, req)
        search_s = time.perf_counter() - t
        moved = (meshed.incremental_refreshes - before[0], meshed.lineage_refreshes - before[1])
        if moved != rises:
            raise AssertionError(f"mesh {step}: refreshes moved by {moved}, expected {rises}")
        cold = executor.execute_search(DeviceCache(root, device=DEVICE, mesh=mesh), req)
        if not result.equals(cold):
            raise AssertionError(f"mesh {step}: the refreshed answer differs from a cold mesh cache's")
        if step == "append" and split_result(result, cos["q"], cos["kw"]["maxval"])[0][0, 0] != rows0:
            raise AssertionError("the appended copy of query 0 is not its first result")
        spec = r["check"][1]
        mask_fn = (lambda dev: torch.from_numpy(live.tags < 50).to(dev)) if spec[5] else None
        out[step] = {"mutate_s": mutate_s, "first_search_s": search_s, "refreshes": moved,
                     "oracle": check_live(live, f"mesh_{step}", spec[2], spec[3], r["queries"], result, mask_fn=mask_fn)}
        emit({"phase": "mesh_mutation", "mutation": step, **out[step], "mesh": mesh.size, "device": kind,
              "nvidia_smi": smi})
    os.environ.pop("FENIX_RING", None)
    return {**out, "rows": int(live.ids.shape[0])}


def mesh_server_checks(kernels, topk2, expr, root: str, reqs, got, an: dict, vectors, smi: str, kind: str) -> dict:
    """Phase 15 (c), on several cards: each design on each card against its
    plain version, then a Flight server started with FENIX_MESH=auto over
    the phase's root answers its requests, and BASELINE config 3's join
    (the partitioned route), as the in-process mesh did, and every card
    launched the stream, tiled, tensor_int8 and tensor_bf16 designs."""
    from fenix_tpu_torch.flight import Flight

    designs = per_card_designs(kernels, topk2)
    emit({"phase": "mesh_designs_per_card", "checks": designs, "device": kind, "nvidia_smi": smi})
    port = free_port()
    log_path = os.path.join(os.path.dirname(root), "server15.log")
    proc, log = start_server(root, port, log_path, {"FENIX_MESH": "auto"})
    client = Flight(host="127.0.0.1", port=port)
    times = {}
    try:
        wait_healthy(client, proc)
        for r in reqs:
            if r["ring"] != "auto":
                continue
            kw = {k: v for k, v in r["kw"].items() if v is not None or k == "maxval"}
            client.search(r["target"], "smoke/items", "vector", **kw)  # warm
            t = time.perf_counter()
            result = client.search(r["target"], "smoke/items", "vector", **kw)
            times[r["name"]] = (time.perf_counter() - t) * 1e3
            if not result.select(["id", "__DISTANCE__"]).equals(got[r["name"]][0].select(["id", "__DISTANCE__"])):
                raise AssertionError(f"{r['name']}: the mesh server answers differently from the in-process mesh")
        name, qn, metric, k, precision, _, _, join, aggregate, _, seed = AN_REQUESTS[0]  # config 3
        kw = dict(metric=metric, maxval=k, precision=precision, join=join, aggregate=aggregate)
        target = make_queries(vectors, qn, seed=seed)[0]
        client.search(target, "smoke/items", "vector", **kw)  # warm
        t = time.perf_counter()
        result = client.search(target, "smoke/items", "vector", **kw)
        times[name] = (time.perf_counter() - t) * 1e3
        if not result.equals(an["results"]["partitioned"][name][2]):
            raise AssertionError(f"{name}: the mesh server's join answers differently from the in-process mesh")
        repartitioned = server_repartition(client, vectors, root, smi, kind)  # phase 16 (c)
        stats = client.stats()
        if not stats.get("join.partitioned"):
            raise AssertionError(f"{name}: the mesh server did not take the partitioned route")
    finally:
        stop_server(client, proc, log, log_path)
    import torch

    per_card = {}
    for card in range(torch.cuda.device_count()):
        per_card[card] = {d: stats.get(f"kernel.bucket_scores.kernel.{d}.cuda{card}.launches", 0)
                          for d in DESIGNS}
        for d in ("stream", "tiled", "tensor_int8", "tensor_bf16"):
            if not per_card[card][d]:
                raise AssertionError(f"card {card} launched no {d} kernel under the mesh server")
    row = {"phase": "mesh_server", "launches_per_card": per_card, "client_ms": times,
           "repartition": repartitioned, "device": kind, "nvidia_smi": smi}
    emit(row)
    return row


def phase_mesh_residency(root: str, live, queries, smi: str, kind: str) -> dict:
    """Phase 15 (b) on the phase-6 root after its server: a mesh cache and
    a single-device cache in process under a per-device budget of
    MESH_BUDGET, where a shard's fp32 copy does not fit and its int8 copy
    does. Each of MESH_RES_SEARCHES moves its counter as the JAX package's
    tests expect; one device answers each in the mode the mesh planned
    (at this budget its own auto plans the stream); fp32 answers equal
    the single device's (ties in id order), int8 answers hold the graded
    rule against it; every answer is held to the float64 oracle over the
    live rows."""
    import torch

    from fenix_tpu_torch import expr
    from fenix_tpu_torch.engine import executor, residency
    from fenix_tpu_torch.engine.session import DeviceCache
    from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

    mesh, shape = mesh_for_run()
    old = os.environ.get("FENIX_HBM_BUDGET")
    os.environ["FENIX_HBM_BUDGET"] = str(MESH_BUDGET)
    results: dict = {"mesh": {}, "single": {}}
    rows, mesh_modes = [], {}
    try:
        for which, cache in (("mesh", DeviceCache(root, device=DEVICE, mesh=mesh)),
                             ("single", DeviceCache(root, device=DEVICE, mesh=None))):
            for name, qn, mode, precision, counter, window in MESH_RES_SEARCHES:
                req = executor.SearchRequest(source="smoke/wide", column="vector", target=queries[qn], metric="l2",
                                             maxval=RES_K, precision=precision, residency=mode,
                                             filter=expr.field("tag") < 50,
                                             extra={"window": window} if window else {})
                planned = residency.plan(cache, req)
                if which == "mesh":
                    mesh_modes[name] = planned
                else:  # one device answers in the mode the mesh planned (its own auto may differ)
                    req.residency = mesh_modes[name]
                before = METRICS.snapshot().get(counter, 0) if counter else 0
                t = time.perf_counter()
                results[which][name] = executor.execute_search(cache, req)
                took = time.perf_counter() - t
                rose = METRICS.snapshot().get(counter, 0) - before if counter else 0
                if which == "mesh":
                    want = 1
                    if counter == "search.stream_chunks":  # the per-device chunk, S of them a chunk
                        n_rows, step = live.ids.shape[0], cache.block * mesh.size
                        chunk = min(residency._stream_chunk_rows(MESH_BUDGET, queries[qn].shape[1], cache.block,
                                                                 1 if precision == "int8" else 4) * mesh.size,
                                    max(-(-n_rows // step) * step, step))
                        want = -(-n_rows // chunk)
                    if counter and rose != want:
                        raise AssertionError(f"mesh {name}: {counter} rose by {rose}, expected {want}")
                    if name == "mesh_auto_q8" and planned != residency.INT8:
                        raise AssertionError(f"mesh {name}: auto planned {planned}, not int8")
                rows.append({"cache": which, "search": name, "q": qn, "residency": req.residency, "planned": planned,
                             "precision": precision, "first_s": took, "counter": counter, "counter_rose": rose})
                emit({"phase": "mesh_residency_search", **rows[-1], "budget_per_device": MESH_BUDGET,
                      "mesh": shape, "device": kind, "nvidia_smi": smi})
            del cache
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    finally:
        if old is None:
            os.environ.pop("FENIX_HBM_BUDGET", None)
        else:
            os.environ["FENIX_HBM_BUDGET"] = old
    checks = {}
    oracle = Oracle(live.parts, DEVICE)
    mask = torch.from_numpy(live.tags < 50).to(oracle.device)
    for name, qn, mode, precision, *_ in MESH_RES_SEARCHES:
        got, want = results["mesh"][name], results["single"][name]
        graded = precision == "int8" or mode in ("auto", "int8")
        if graded:
            check_graded(f"mesh_{name}", got, want)
            checks[name] = {"graded": True}
        else:
            checks[name] = check_mesh_vs_single(f"mesh_{name}", got, want, qn)
        ids, dist = split_result(got, qn, RES_K)
        pos = live.pos(ids)  # padding (-1) stays -1
        if ((pos < 0) & (ids >= 0)).any():
            raise AssertionError(f"mesh_{name}: returned ids that are not in the table")
        checks[name]["oracle"] = check_ids(oracle, f"mesh_{name}", "l2", RES_K, "int8" if graded else "fp32",
                                           queries[qn], pos, dist, mask, require_ties=False)
    del oracle, mask
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    for name, check in checks.items():
        emit({"phase": "mesh_residency_check", "search": name, **check})
    return {"rows": rows, "mesh": shape}


# -- phase 16: the shuffle, repartition on the mesh, the dim-sharded search ----


def shuffle_spy(pshuffle, calls: list):
    """Put a recording stand-in for ``pshuffle.build_shuffle`` in place:
    each exchange it builds appends its capacity, chunks, whether a
    window overflowed and its seconds (host clock to the cards' end) to
    ``calls``. Returns the original, for the caller to put back."""
    build = pshuffle.build_shuffle

    def spy(mesh, capacity, row_shape, chunks=1):
        fn = build(mesh, capacity, row_shape, chunks)

        def run(rows, keys):
            sync()
            t = time.perf_counter()
            out = fn(rows, keys)
            sync()
            calls.append({"capacity": capacity, "chunks": chunks, "exchange_s": time.perf_counter() - t,
                          "overflow": bool(out[3].gather().any())})
            return out

        return run

    pshuffle.build_shuffle = spy
    return build


def shuffle_ids_case(mesh, shape, keys, name: str, smi: str, kind: str) -> dict:
    """Phase 16 (a), one key set: ``distributed._device_shuffle_ids``
    against the host path (``native.hash_partition`` and ``flatnonzero``),
    each shard's ids equal, with the capacities it tried."""
    import numpy as np

    from fenix_tpu_torch import native
    from fenix_tpu_torch.parallel import distributed
    from fenix_tpu_torch.parallel import shuffle as pshuffle

    n_shards = mesh.size
    t = time.perf_counter()
    parts, _ = native.hash_partition(keys, n_shards)
    want = [np.flatnonzero(parts == s) for s in range(n_shards)]
    host_s = time.perf_counter() - t
    del parts
    calls: list = []
    build = shuffle_spy(pshuffle, calls)
    try:
        sync()
        t = time.perf_counter()
        got = distributed._device_shuffle_ids(mesh, keys, n_shards)
        sync()
        device_s = time.perf_counter() - t
    finally:
        pshuffle.build_shuffle = build
    for s in range(n_shards):
        if not np.array_equal(got[s], want[s]):
            raise AssertionError(f"shuffle {name}: shard {s}'s ids differ from the host hash's")
    n_pad = -(-keys.size // n_shards) * n_shards
    row = {"phase": "shuffle_ids", "keys": name, "rows": int(keys.size), "shards": n_shards,
           "estimated_capacity": calls[0]["capacity"], "bound": n_pad // n_shards,
           "took_capacity": calls[-1]["capacity"], "tries": calls, "device_s": device_s, "host_s": host_s,
           "rows_per_shard": [int(g.size) for g in got], "clock": "host, keys on the host to ids on the host",
           "mesh": shape, "device": kind, "nvidia_smi": smi}
    emit(row)
    return row


def phase_shuffle_ids(mesh, shape, smi: str, kind: str) -> dict:
    """Phase 16 (a): the id shuffle of repartition over SH_KEYS int64 keys,
    a seeded permutation (must go through at the estimated capacity), then
    the same keys with their first SH_HOT of rows on one key, all on the
    first source shards (must overflow there and go through on the retry
    at the provable bound n_pad // S)."""
    import numpy as np

    keys = np.random.default_rng(1600).permutation(SH_KEYS).astype(np.int64)
    uniform = shuffle_ids_case(mesh, shape, keys, "uniform", smi, kind)
    if [c["overflow"] for c in uniform["tries"]] != [False]:
        raise AssertionError(f"uniform keys: not through at the estimated capacity: {uniform['tries']}")
    keys[: int(SH_HOT * SH_KEYS)] = keys[0]
    skewed = shuffle_ids_case(mesh, shape, keys, "skewed", smi, kind)
    last = skewed["tries"][-1]
    if [c["overflow"] for c in skewed["tries"]] != [True, False] or (
            last["capacity"] != -(-skewed["bound"] // last["chunks"]) * last["chunks"]):
        raise AssertionError(f"skewed keys: no overflow, then the retry at n_pad // S: {skewed['tries']}")
    return {"uniform": uniform, "skewed": skewed}


def phase_shuffle_payload(mesh, shape, smi: str, kind: str) -> dict:
    """Phase 16 (b): ``build_shuffle`` of SH_PAYLOAD_ROWS fp32 rows of
    SH_PAYLOAD_D a shard (made on the card from a seed), keyed by a seeded
    permutation of the row numbers, at twice the balanced share. chunks=1
    and chunks=4 bitwise equal; no window over; every row arrives once,
    with its key, on its hash's shard, equal to its source row. Each
    chunking timed SH_REPS times after the checked call (host clock
    around the exchange, synchronised), with the bytes it moves."""
    import numpy as np
    import torch

    from fenix_tpu_torch.ops import relational
    from fenix_tpu_torch.parallel import shuffle as pshuffle
    from fenix_tpu_torch.parallel.search import Sharded

    n_shards, b, d = mesh.size, SH_PAYLOAD_ROWS, SH_PAYLOAD_D
    cap = 2 * b // n_shards
    keys_np = np.random.default_rng(1610).permutation(n_shards * b).astype(np.int32)
    rows = Sharded(mesh, [torch.randn((b, d), generator=torch.Generator(dev).manual_seed(1620 + s), device=dev)
                          for s, dev in enumerate(mesh.devices)])
    keys = Sharded(mesh, [torch.from_numpy(keys_np[s * b : (s + 1) * b]).to(dev)
                          for s, dev in enumerate(mesh.devices)])
    out, times = {}, {}
    for chunks in (1, 4):
        fn = pshuffle.build_shuffle(mesh, cap, (d,), chunks=chunks)
        out[chunks] = fn(rows, keys)
        ms = []
        for _ in range(SH_REPS):
            sync()
            t = time.perf_counter()
            fn(rows, keys)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        times[chunks] = ms
    for part, one, four in zip(("recv", "recv_keys", "valid", "overflow"), out[1], out[4]):
        if not all(torch.equal(x, y) for x, y in zip(one.shards, four.shards)):
            raise AssertionError(f"payload shuffle: chunks=4's {part} differs from chunks=1's")
    recv, recv_keys, valid, overflow = out.pop(1)
    del out
    if any(bool(o.any()) for o in overflow.shards):
        raise AssertionError("payload shuffle: a window overflowed at twice the balanced share")
    row_of_key = torch.from_numpy(np.argsort(keys_np))  # key -> global row
    arrived = []
    for dst, dev in enumerate(mesh.devices):
        wk, wv = recv_keys.shards[dst].view(n_shards, cap), valid.shards[dst].view(n_shards, cap)
        wr = recv.shards[dst].view(n_shards, cap, d)
        for src, src_dev in enumerate(mesh.devices):
            k = wk[src][wv[src]]
            if not bool((relational.hash_partition(k, n_shards) == dst).all()):
                raise AssertionError(f"payload shuffle: a key on shard {dst} does not hash there")
            local = row_of_key.to(src_dev)[k.to(src_dev).long()] - src * b
            if bool(((local < 0) | (local >= b)).any()):
                raise AssertionError(f"payload shuffle: window {src} of shard {dst} holds another source's keys")
            if not torch.equal(wr[src][wv[src]].to(src_dev), rows.shards[src][local]):
                raise AssertionError(f"payload shuffle: rows of window {src} on shard {dst} are not their keys' rows")
            arrived.append(k.to(mesh.devices[0]))
    arrived = torch.sort(torch.cat(arrived)).values
    if not torch.equal(arrived.cpu(), torch.arange(n_shards * b, dtype=arrived.dtype)):
        raise AssertionError("payload shuffle: not every row arrived exactly once")
    payload = n_shards * b * (d * 4 + 4)  # each row and its key move once
    windows = n_shards * n_shards * cap * (d * 4 + 4 + 1)
    row = {"phase": "shuffle_payload", "rows_per_shard": b, "width": d, "shards": n_shards, "capacity": cap,
           "payload_bytes": payload, "window_bytes": windows,
           **{f"chunks{c}_ms": ms for c, ms in times.items()},
           **{f"chunks{c}_median_ms": float(np.median(ms)) for c, ms in times.items()},
           **{f"chunks{c}_payload_gb_per_s": payload / (float(np.median(ms)) * 1e6) for c, ms in times.items()},
           **{f"chunks{c}_window_gb_per_s": windows / (float(np.median(ms)) * 1e6) for c, ms in times.items()},
           "clock": "host, synchronised", "mesh": shape, "device": kind, "nvidia_smi": smi}
    emit(row)
    return row


def ids_agree(oracle, name: str, metric: str, queries, got, want, rel: float) -> int:
    """[Q, k] row positions ``got`` against ``want``: equal, except where
    the two rows' float64 distances to the query are within ``rel`` *
    max(1, d) of each other (near ties, which no fp32 engine orders).
    Returns the count of such differing positions."""
    import numpy as np
    import torch

    differ = got != want
    if not differ.any():
        return 0
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(oracle.device, torch.float64)

    def d64(pos):
        return oracle.exact(q, torch.from_numpy(np.where(pos >= 0, pos, 0)).to(oracle.device), metric).cpu().numpy()

    dg, dw = d64(got), d64(want)
    bad = differ & ((got < 0) | (want < 0) | (np.abs(dg - dw) > rel * np.maximum(1.0, np.abs(dw))))
    if bad.any():
        raise AssertionError(f"{name}: ids differ at {int(bad.sum())} positions beyond ties")
    return int(differ.sum())


def canonical_ties(pos, dist):
    """``pos`` [Q, k] with each run of equal fp32 distances put in row
    order: exact ties resolve by table order, which a repartition changes.
    Padding (-1, +inf) stays last."""
    import numpy as np

    order = np.lexsort((np.where(pos >= 0, pos, np.iinfo(np.int64).max), dist))
    return np.take_along_axis(pos, order, axis=1)


def repartition_search_check(oracle, live, r: dict, before, after) -> dict:
    """A search over the repartitioned name against the same search before
    it: ids per query equal with each group of exactly tied fp32 distances
    as a set (both put in row order), but where a group straddles the k-th
    place, whose rows may differ within NEAR_TIE (phase 4's rule);
    distances within 1e-5 * max(1, d). Both are held to the float64 oracle
    over the live rows by phase 4's rule."""
    import numpy as np
    import torch

    name, qn, metric, k, precision, filtered, _ = r["check"][1]
    b_ids, b_d = split_result(before, qn, k)
    a_ids, a_d = split_result(after, qn, k)
    b_pos, a_pos = live.pos(b_ids), live.pos(a_ids)
    if ((a_pos < 0) & (a_ids >= 0)).any():
        raise AssertionError(f"{name}: returned ids not in the table")
    mask = torch.from_numpy(live.tags < 50).to(oracle.device) if filtered else None
    out = {"before": check_ids(oracle, f"{name}_before", metric, k, precision, r["queries"], b_pos, b_d, mask,
                               require_ties=False)}
    canon = canonical_ties(a_pos, a_d)
    out["after"] = check_ids(oracle, f"{name}_after", metric, k, precision, r["queries"], canon, a_d, mask,
                             require_ties=False)
    out["tie_reorders"] = int((canon != a_pos).sum())
    out["near_tie_swaps_vs_before"] = ids_agree(oracle, name, metric, r["queries"], canon,
                                                canonical_ties(b_pos, b_d), NEAR_TIE)
    real = b_pos >= 0
    err = np.abs(np.where(real, a_d - b_d, 0.0)) / np.maximum(1.0, np.abs(np.where(real, b_d, 0.0)))
    if err.max(initial=0.0) > 1e-5:
        raise AssertionError(f"{name}: distances after the repartition off by {err.max()} relative")
    out["max_rel_dist_diff"] = float(err.max(initial=0.0))
    return out


def repartition_read_check(oracle, live, r: dict, before, after) -> dict:
    """MESH_READ over the repartitioned name: per query the rows selected
    before it (now in shard order), distances within 1e-5 * max(1, d);
    both held to the float64 oracle (check_selection, rows in live
    order)."""
    import numpy as np
    import pyarrow as pa

    rows = np.flatnonzero(tag_mask(live.tags, r["check"][1]))
    placed = []
    for label, res in (("before", before), ("after", after)):
        pos = live.pos(np.asarray(res.column("id")))
        qid = res.column("__QUERY_ID__").to_numpy()
        order = np.lexsort((pos, qid))
        placed.append(pa.table({"id": pos[order], "__DISTANCE__": np.asarray(res.column("__DISTANCE__"))[order],
                                "__QUERY_ID__": qid[order]}))
    checks = {label: check_selection(oracle, f"{r['name']}_{label}", r["kw"]["metric"], r["queries"], t,
                                     lambda qi: rows) for label, t in zip(("before", "after"), placed)}
    b, a = (np.asarray(t.column("__DISTANCE__")) for t in placed)
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    if err.max(initial=0.0) > 1e-5:
        raise AssertionError(f"{r['name']}: distances after the repartition off by {err.max()} relative")
    return {**checks, "max_rel_dist_diff": float(err.max(initial=0.0))}


def phase_repartition(mesh, shape, root: str, live, reqs, smi: str, kind: str) -> dict:
    """Phase 16 (c): ``distributed.repartition`` of (a)'s table (after
    phase 15's mutations: ``live``) into S shards on the mesh. A spy on
    ``_device_shuffle_ids`` shows the device branch; the shard tables hold
    the host path's placement of the same keys. Phase 15 (a)'s five
    searches and MESH_READ through ``executor.execute_search`` on a mesh
    cache over the resolved name (every count 0 just before, read just
    after: the repartition path) equal the answers before it."""
    import numpy as np
    import torch

    from fenix_tpu_torch import native
    from fenix_tpu_torch.engine import executor
    from fenix_tpu_torch.engine.session import DeviceCache
    from fenix_tpu_torch.io import table
    from fenix_tpu_torch.ops import kernels
    from fenix_tpu_torch.parallel import distributed

    name = "smoke/items"
    chosen = [r for r in reqs if r["check"][0] in ("search", "read") and r["ring"] == "auto"]
    before, _ = run_requests(executor, DeviceCache(root, device=DEVICE, mesh=mesh), chosen, 0)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    calls = []
    inner = distributed._device_shuffle_ids

    def spy(m, keys, num_shards):
        calls.append(num_shards)
        return inner(m, keys, num_shards)

    distributed._device_shuffle_ids = spy
    try:
        t = time.perf_counter()
        manifest = distributed.repartition(root, name, mesh.size, mesh=mesh)
        repartition_s = time.perf_counter() - t
    finally:
        distributed._device_shuffle_ids = inner
    if calls != [mesh.size]:
        raise AssertionError(f"repartition on the mesh did not take the device shuffle: {calls}")
    parts, _ = native.hash_partition(live.ids, mesh.size)
    shard_rows = []
    for s in range(manifest.num_shards):
        got = np.asarray(table.load(root, manifest.shard_name(s)).column("id"))
        if not np.array_equal(got, live.ids[parts == s]):
            raise AssertionError(f"shard table {s} differs from the host path's placement")
        shard_rows.append(int(got.size))
    source = distributed.resolve_source(root, name)
    if source != [manifest.shard_name(s) for s in range(mesh.size)]:
        raise AssertionError(f"{name} resolves to {source}")

    for counts in (kernels.LAUNCHES, kernels.DEVICE_LAUNCHES):
        for key in counts:
            counts[key] = 0
    after, routes = run_requests(executor, DeviceCache(root, device=DEVICE, mesh=mesh), chosen, MESH_WARM_REPS,
                                 source=source)
    sync()
    launches = {k.removeprefix("bucket_scores."): v for k, v in kernels.LAUNCHES.items()}
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "repartition", "rows": int(live.ids.shape[0]), "shards": manifest.num_shards,
          "shard_rows": shard_rows, "seconds": repartition_s, "device_route_calls": len(calls),
          "launches": launches, "mesh": shape, "device": kind, "nvidia_smi": smi})

    oracle = Oracle(live.parts, DEVICE)
    for r in chosen:
        if sum(routes[r["name"]].values()) != MESH_WARM_REPS + 1:
            raise AssertionError(f"{r['name']}: route counters moved {routes[r['name']]} over the shards")
        result, first, warm = after[r["name"]]
        check = (repartition_read_check if r["check"][0] == "read" else repartition_search_check)(
            oracle, live, r, before[r["name"]][0], result)
        emit({"phase": "repartition_search", "search": r["name"], "q": r["q"], "first_s": first,
              "warm_median_ms": float(np.median(warm)), "before_first_s": before[r["name"]][1],
              "routes": routes[r["name"]], **check, "clock": "host, in process", "mesh": shape, "device": kind,
              "nvidia_smi": smi})
    del oracle
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "seconds": repartition_s, "shard_rows": shard_rows}


def dim_mesh():
    """Phase 16 (d)'s (2, 2) mesh: one shard a card on four or more cards,
    else four shards on the first card (or the CPU)."""
    import torch

    from fenix_tpu_torch.parallel.mesh import make_mesh

    if DEVICE == "cuda" and torch.cuda.device_count() >= 4:
        return make_mesh(4, model_parallel=2)
    return make_mesh(devices=[f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * 4, model_parallel=2)


def lloyd_near_ties(books, batch):
    """Centroids ``[n, K]`` that a float64 near tie (the two nearest within
    1e-5 relative) could move between two fp32 Lloyd steps."""
    import torch

    n, k, _ = books.shape
    touched = torch.zeros((n, k), dtype=torch.bool, device=books.device)
    for j in range(n):
        c = books[j].double()
        csq = (c * c).sum(1)
        for s in range(0, batch.shape[1], 4096):
            x = batch[j, s : s + 4096].double()
            top = torch.topk((x * x).sum(1, keepdim=True) - 2.0 * x @ c.T + csq[None, :], 2, dim=1, largest=False)
            d = top.values.clamp_min(0.0).sqrt()
            near = (d[:, 1] - d[:, 0]) <= 1e-5 * d[:, 1]
            touched[j, top.indices[near].reshape(-1)] = True
    return touched


def sharded_lloyd_checks(dmesh, vectors, smi: str, kind: str) -> list[dict]:
    """``kmeans.sharded_lloyd_step`` at phase 7's coder shapes (IVF_CELLS
    centroids of D, IVF_STEP_ROWS rows) on the (2, 2) mesh, one book with
    the rows over the data axis, then two books over the model axis,
    against ``lloyd_step_single`` on one device: within 1e-5 of the largest
    entry, but for centroids a float64 near tie could move."""
    import numpy as np
    import torch

    from fenix_tpu_torch.ops import kmeans
    from fenix_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    d = vectors.shape[1]
    pick = np.random.default_rng(1640).choice(vectors.shape[0], 2 * IVF_CELLS + IVF_STEP_ROWS, replace=False)
    dev0 = dmesh.devices[0]
    out = []
    for n_books, axis in ((1, None), (2, MODEL_AXIS)):
        books = torch.from_numpy(vectors[pick[: n_books * IVF_CELLS]]).to(dev0).view(n_books, IVF_CELLS, d)
        batch = torch.from_numpy(vectors[pick[2 * IVF_CELLS :]]).to(dev0).view(n_books, -1, d)
        step = kmeans.sharded_lloyd_step(dmesh, DATA_AXIS, axis, "l2")
        got, first, warm = in_process(lambda: step(books, batch), MESH_WARM_REPS)
        want = torch.stack([kmeans.lloyd_step_single(books[j], batch[j], "l2") for j in range(n_books)])
        touched = lloyd_near_ties(books, batch)
        err = (got - want).abs().amax(dim=-1) / want.abs().max()
        worst = float(err[~touched].max()) if bool((~touched).any()) else 0.0
        if worst > 1e-5:
            raise AssertionError(f"sharded Lloyd step ({n_books} books) off one device's by {worst} of the largest")
        row = {"phase": "sharded_lloyd_step", "books": n_books, "model_axis": axis, "centroids": IVF_CELLS,
               "rows": IVF_STEP_ROWS, "max_err_of_largest": worst, "near_tie_centroids": int(touched.sum()),
               "first_s": first, "warm_ms": warm, "clock": "host, synchronised",
               "mesh": {"data": 2, "model": 2, "devices": [str(x) for x in dmesh.devices]}, "device": kind,
               "nvidia_smi": smi}
        emit(row)
        out.append(row)
    return out


def phase_dim_sharded(mesh, vectors, oracle, smi: str, kind: str) -> dict:
    """Phase 16 (d): ``build_dim_sharded_search`` over phase 3's rows on the
    (2, 2) mesh (rows over the data axis, columns over the model axis),
    DIM_Q queries top-DIM_K for each of DIM_METRICS, held to the float64
    oracle (phase 4's rule, distances within 1e-4 * max(1, d)) and to the
    row-sharded search on phase 15's mesh (ids equal up to near ties),
    each timed (host clock, synchronised); then the sharded Lloyd step."""
    import numpy as np
    import torch

    from fenix_tpu_torch.ops import topk2
    from fenix_tpu_torch.parallel import search as psearch

    dmesh = dim_mesh()
    dev0 = dmesh.devices[0]
    n, d = vectors.shape
    t = time.perf_counter()
    corpus, mask = psearch.shard_corpus_dim(dmesh, vectors)
    rows, rows_mask = psearch.shard_corpus(mesh, vectors)
    sync()
    place_s = time.perf_counter() - t
    full = torch.from_numpy(vectors)
    if corpus.shape[0] > n:
        full = torch.cat([full, torch.zeros((corpus.shape[0] - n, d))])
    host_mask = torch.cat([m.cpu() for m in mask])
    out = []
    for i, metric in enumerate(DIM_METRICS):
        q = make_queries(vectors, DIM_Q, seed=1630 + i)
        mul, add = topk2.prepare_aux(full, host_mask, metric)  # of the full-D rows, before placement
        q_t = torch.from_numpy(q)
        args = (corpus, topk2.prepare_queries(q_t, metric).to(dev0), corpus.data_rows(mul), corpus.data_rows(add),
                (q_t.double() ** 2).sum(1).float())
        fn = psearch.build_dim_sharded_search(dmesh, DIM_K, metric)
        (dist, ids), first, warm = in_process(lambda: fn(*args), MESH_WARM_REPS)
        row_aux = psearch.shard_aux(rows, rows_mask, metric)
        row_fn = psearch.build_sharded_search(mesh, DIM_K, metric, with_aux=True)
        q_dev = q_t.to(mesh.devices[0])
        (r_dist, r_ids), r_first, r_warm = in_process(lambda: row_fn(rows, q_dev, rows_mask, *row_aux), MESH_WARM_REPS)
        name = f"dim_sharded_{metric}"
        ids_np, dist_np = ids.cpu().numpy(), dist.cpu().numpy()
        check = check_ids(oracle, name, metric, DIM_K, "fp32", q, ids_np, dist_np, None, require_ties=False)
        swaps = ids_agree(oracle, name, metric, q, ids_np, r_ids.cpu().numpy(), NEAR_TIE)
        row = {"phase": "dim_sharded", "search": name, "q": DIM_Q, "k": DIM_K, "rows": n, "dim": d,
               "first_s": first, "warm_ms": warm, "warm_median_ms": float(np.median(warm)),
               "row_sharded_first_s": r_first, "row_sharded_warm_ms": r_warm,
               "row_sharded_warm_median_ms": float(np.median(r_warm)), "near_tie_swaps_vs_row_sharded": swaps,
               "placement_s": place_s, **check, "clock": "host, synchronised",
               "mesh": {"data": 2, "model": 2, "devices": [str(x) for x in dmesh.devices]},
               "row_mesh_shards": mesh.size, "device": kind, "nvidia_smi": smi}
        emit(row)
        out.append(row)
        del row_aux
    del corpus, mask, rows, rows_mask
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"searches": out, "lloyd": sharded_lloyd_checks(dmesh, vectors, smi, kind)}


def server_repartition(client, vectors, root: str, smi: str, kind: str) -> dict:
    """Phase 16 (c) on several cards: a second table of SH_SERVER_ROWS rows
    (past phase 3's duplicates, so no two tie) put over Flight to (c)'s
    FENIX_MESH=auto server, then Flight ``repartition`` with its default
    shard count: one shard a card, the host hash's placement, the upload
    of the (key, id) pairs in the server's transfer.h2d_bytes (the host
    path uploads nothing), and a search as before it."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fenix_tpu_torch import native
    from fenix_tpu_torch.io import ingest, table

    cards = torch.cuda.device_count()
    name = "smoke/second"
    lo = 2 * DUP
    ids = np.arange(lo, lo + SH_SERVER_ROWS, dtype=np.int64)
    rows = vectors[lo : lo + SH_SERVER_ROWS]
    schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), vectors.shape[1])})
    client.make_table(name, pa.RecordBatchReader.from_batches(schema, (
        pa.record_batch([pa.array(ids[s : s + BATCH_ROWS]),
                         ingest.numpy_to_fixed_size_list(rows[s : s + BATCH_ROWS], pa.float32())], schema=schema)
        for s in range(0, SH_SERVER_ROWS, BATCH_ROWS))))
    target = make_queries(rows, 8, seed=1650)
    before = client.search(target, name, "vector", metric="l2", maxval=10)
    h2d = client.stats().get("transfer.h2d_bytes", 0)
    t = time.perf_counter()
    manifest = client.repartition(name)
    seconds = time.perf_counter() - t
    uploaded = client.stats().get("transfer.h2d_bytes", 0) - h2d
    if manifest["num_shards"] != cards or uploaded < 8 * SH_SERVER_ROWS:
        raise AssertionError(f"Flight repartition: {manifest}, {uploaded} bytes uploaded: not the device shuffle")
    parts, _ = native.hash_partition(ids, cards)
    for s in range(cards):
        got = np.asarray(table.load(root, f"{name}@{s}").column("id"))
        if not np.array_equal(got, ids[parts == s]):
            raise AssertionError(f"Flight repartition: shard table {s} differs from the host path's placement")
    after = client.search(target, name, "vector", metric="l2", maxval=10)
    check = check_mesh_vs_single("server_repartition", after, before, 8)
    row = {"phase": "server_repartition", "rows": SH_SERVER_ROWS, "num_shards": manifest["num_shards"],
           "seconds": seconds, "h2d_bytes": uploaded, **check, "device": kind, "nvidia_smi": smi}
    emit(row)
    return row


def phase_shuffle(mesh, shape, root: str, live, reqs, vectors, oracle, smi: str, kind: str) -> dict:
    """Phase 16 (see the module docstring), on phase 15's mesh after its
    checks: (d) first, with phase 15's oracle over phase 3's rows, then
    (a), (b) and (c) on (a)'s root. Returns the repartition path's
    launches."""
    import torch

    t = time.perf_counter()
    dim = phase_dim_sharded(mesh, vectors, oracle, smi, kind)
    emit({"phase": "dim_sharded_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    ids = phase_shuffle_ids(mesh, shape, smi, kind)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "shuffle_ids_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    payload = phase_shuffle_payload(mesh, shape, smi, kind)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "shuffle_payload_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    rep = phase_repartition(mesh, shape, root, live, reqs, smi, kind)
    emit({"phase": "repartition_done", "seconds": time.perf_counter() - t})
    return {"launches": rep["launches"], "ids": ids, "payload": payload, "repartition": rep, "dim": dim}


# -- phase 17: multi-host -------------------------------------------------------


def mh_config() -> dict:
    """What phase 17's legs read besides their input files, from this
    module's constants: the workers are fresh processes of this script and
    read it from the work directory."""
    return {"device": DEVICE, "searches": [list(s) for s in SEARCHES],
            "joins": [list(r) for r in AN_REQUESTS if r[0] in MH_JOINS], "train": MESH_TRAIN_CHECK,
            "payload": [SH_PAYLOAD_ROWS, SH_PAYLOAD_D], "stream": list(MH_STREAM),
            "dim": [DIM_Q, DIM_K, list(DIM_METRICS)], "attr_rows": AN_ATTRS_ROWS, "reps": MH_REPS}


def mh_layout() -> tuple[list, list, list]:
    """``(one process's devices, each worker's devices, each worker's
    CUDA_VISIBLE_DEVICES)``: on four cards or more each worker takes two
    cards (NCCL) and the one process a card a shard; else both workers put
    their two shards on the first card (gloo) and the one process its four."""
    import torch

    per = MH_SHARDS // MH_PROCS
    if DEVICE == "cuda" and torch.cuda.device_count() >= MH_SHARDS:
        visible = [",".join(str(p * per + i) for i in range(per)) for p in range(MH_PROCS)]
        return [f"cuda:{i}" for i in range(MH_SHARDS)], [[f"cuda:{i}" for i in range(per)]] * MH_PROCS, visible
    dev = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    return [dev] * MH_SHARDS, [[dev] * per] * MH_PROCS, [None] * MH_PROCS


MH_FILES = ("vectors", "tags", "hot_keys", "payload_keys", "parted_keys", "parted_rows", "parted_grp",
            "parted_weight", "parted_bounds")


def mh_write_inputs(work: str, vectors, tags, queries, cfg: dict) -> None:
    """The legs' inputs as files under ``work``: phase 3's rows and tags,
    the queries (phase 3's, phase 11's join seeds, the stream's, phase 16
    (d)'s), (d)'s hot keys (phase 16 (a)'s rule over phase 3's row count)
    and payload keys, and config 3's attribute side as
    ``DeviceCache.parted_key`` / ``parted_scalar`` lay it out: the keys
    padded with INT32_MAX to a multiple of the shard count, sorted stably,
    their original rows, grp (int32) and weight (float32) in that order
    (0 on the padding), and each range's lower bound."""
    import numpy as np

    def save(name: str, array) -> None:
        np.save(os.path.join(work, f"{name}.npy"), array)

    n = vectors.shape[0]
    save("vectors", vectors)
    save("tags", tags)
    qs = {f"search_{i}": q for i, q in enumerate(queries)}
    for r in cfg["joins"]:
        qs[f"join_{r[0]}"] = make_queries(vectors, r[1], seed=r[-1])
    qs["stream"] = make_queries(vectors, cfg["stream"][0], seed=1700)
    for i, metric in enumerate(cfg["dim"][2]):
        qs[f"dim_{metric}"] = make_queries(vectors, cfg["dim"][0], seed=1630 + i)
    np.savez(os.path.join(work, "queries.npz"), **qs)
    hot = np.random.default_rng(1600).permutation(n).astype(np.int64)
    hot[: int(SH_HOT * n)] = hot[0]
    save("hot_keys", hot)
    save("payload_keys", np.random.default_rng(1610).permutation(MH_SHARDS * cfg["payload"][0]).astype(np.int32))
    attrs, _ = analytics_tables()
    rows = attrs["key"].shape[0]
    keys = np.full(-(-rows // MH_SHARDS) * MH_SHARDS, np.iinfo(np.int32).max, np.int32)
    keys[:rows] = attrs["key"]
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    real, at = perm < rows, np.minimum(perm, rows - 1)
    sk = keys[perm]
    bounds = np.full(MH_SHARDS, np.iinfo(np.int32).min, np.int32)
    bounds[1:] = sk[np.arange(1, MH_SHARDS) * (keys.shape[0] // MH_SHARDS) - 1]
    save("parted_keys", sk)
    save("parted_rows", perm)
    save("parted_grp", np.where(real, attrs["grp"][at], 0).astype(np.int32))
    save("parted_weight", np.where(real, attrs["weight"][at], 0.0).astype(np.float32))
    save("parted_bounds", bounds)


def mh_inputs(work: str) -> dict:
    """The input files mapped (a process reads only the rows it uploads)
    and the queries."""
    import numpy as np

    out = {name: np.load(os.path.join(work, f"{name}.npy"), mmap_mode="r") for name in MH_FILES}
    with np.load(os.path.join(work, "queries.npz")) as z:
        out["queries"] = {k: z[k] for k in z.files}
    return out


def mh_rows(mesh, n: int) -> tuple[int, int]:
    """This process's contiguous row range of an ``n``-row array on ``mesh``."""
    per = n // mesh.size
    return mesh.local_shards[0] * per, (mesh.local_shards[-1] + 1) * per


def mh_put(psearch, mesh, host, fill=0, dtype=None):
    """``host`` row-sharded over ``mesh``, this process reading and
    uploading its own rows only (``put_rows`` from ``start``)."""
    lo, hi = mh_rows(mesh, host.shape[0])
    return psearch.put_rows(mesh, host[lo:hi], host.shape[0], fill, dtype, start=lo)


def mh_digest(x) -> list:
    """Two sums over ``x`` as int32 words (bools widened), on its device:
    the plain sum and the sum weighted by position mod 65,521, both mod
    2^64. Equal for equal tensors; two runs that differ anywhere differ in
    them but by an accident of arithmetic."""
    import torch

    w = (x.to(torch.int32) if x.dtype == torch.bool else x.contiguous().view(torch.int32)).reshape(-1)
    s1 = torch.zeros((), dtype=torch.int64, device=w.device)
    s2 = torch.zeros((), dtype=torch.int64, device=w.device)
    for start in range(0, w.numel(), MH_DIGEST_WORDS):
        blk = w[start : start + MH_DIGEST_WORDS].long()
        pos = torch.arange(start, start + blk.numel(), device=w.device) % 65_521 + 1
        s1 += blk.sum()
        s2 += (blk * pos).sum()
    return [int(s1), int(s2)]


def mh_legs(mesh, inp: dict, cfg: dict) -> tuple[dict, dict, dict]:
    """Phase 17's legs on ``mesh``: ``(arrays, times, notes)``. A worker's
    mesh spans both processes; the reference is one process's mesh of the
    same four shards. Every array is replicated (the same on every
    process) but the ring's blocks (from ``notes["ring_q_start"]``), the
    payload digests and the id shuffle's ids, which are this process's
    own shards'. Each leg: one call, then ``cfg["reps"]`` warm ones (host
    clock to the result, synchronised)."""
    import numpy as np
    import torch

    from fenix_tpu_torch.engine import analytics
    from fenix_tpu_torch.io import ingest
    from fenix_tpu_torch.ops import kmeans, topk2
    from fenix_tpu_torch.parallel import distributed
    from fenix_tpu_torch.parallel import search as psearch
    from fenix_tpu_torch.parallel import shuffle as pshuffle

    out, times, notes = {}, {}, {}
    vec, tags, lead = inp["vectors"], inp["tags"], mesh.lead
    n = vec.shape[0]
    lo, hi = mh_rows(mesh, n)

    def timed(name: str, fn):
        result, first, warm = in_process(fn, cfg["reps"])
        times[name] = {"first_s": first, "warm_ms": warm, "warm_median_ms": float(np.median(warm))}
        return result

    def query(name: str):
        return torch.from_numpy(inp["queries"][name]).to(lead)

    # (a) phase 15 (a)'s five searches over phase 3's rows and their scan copies
    corpus = psearch.put_rows(mesh, vec[lo:hi], n, 0, torch.float32, start=lo)
    masks = {False: psearch.put_rows(mesh, np.ones(hi - lo, bool), n, False, start=lo),
             True: psearch.put_rows(mesh, tags[lo:hi] < 50, n, False, start=lo)}
    scans = {"fp32": (), "bf16": (psearch.shard_scan_bf16(corpus),), "int8": psearch.shard_scan_int8(corpus)}
    auxes: dict = {}

    def aux(metric: str, filtered: bool):
        if (metric, filtered) not in auxes:
            auxes[metric, filtered] = psearch.shard_aux(corpus, masks[filtered], metric)
        return auxes[metric, filtered]

    for i, (name, _, metric, k, precision, filtered, _) in enumerate(cfg["searches"]):
        fn = psearch.build_serving_search(mesh, k, metric, precision=precision)
        args = (corpus, query(f"search_{i}"), *aux(metric, filtered), *scans[precision])
        dist, ids = timed(f"a_{name}", lambda: fn(*args))
        out[f"a_{name}_dist"], out[f"a_{name}_ids"] = dist.cpu().numpy(), ids.cpu().numpy()
    del scans

    # (b) the ring at phase 3's Q=1024 l2 filtered search: this process's blocks
    name, qn, metric, k, _, filtered, _ = cfg["searches"][2]
    ring = psearch.build_ring_search(mesh, k, metric)
    q = query("search_2")
    dist, ids = timed("b_ring", lambda: ring(corpus, q, *aux(metric, filtered)))
    out["b_ring_dist"], out["b_ring_ids"] = dist.cpu().numpy(), ids.cpu().numpy()
    notes["ring_q_start"] = mesh.local_shards[0] * (qn // mesh.size)

    # (c) train_sharded at phase 15's check size, index_add_ deterministic
    rows, tc = cfg["train"]["rows"], cfg["train"]["config"]
    kw = {key: tc[key] for key in ("num_codebooks", "codebook_size", "batch_size", "num_epochs", "metric")}
    sub = mh_put(psearch, mesh, vec[:rows], 0, torch.float32)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        books = timed("c_train_sharded", lambda: kmeans.train_sharded(mesh, sub, rows, 0, **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    out["c_codebooks"] = books.cpu().numpy()
    del sub

    # (d) phase 16 (b)'s payload exchange at chunks 1 and 4, then the id shuffle's retry
    b, width = cfg["payload"]
    cap = 2 * b // mesh.size
    rows_p = psearch.Sharded(mesh, [
        torch.randn((b, width), generator=torch.Generator(dev).manual_seed(1620 + s), device=dev)
        if mesh.is_local(s) else None for s, dev in enumerate(mesh.devices)])
    keys_p = mh_put(psearch, mesh, inp["payload_keys"])
    for chunks in (1, 4):
        exchange = pshuffle.build_shuffle(mesh, cap, (width,), chunks=chunks)
        got = timed(f"d_payload_chunks{chunks}", lambda: exchange(rows_p, keys_p))
        for part, arr in zip(("recv", "recv_keys", "valid"), got[:3]):
            for s in mesh.local_shards:
                out[f"d_payload{chunks}_{part}_{s}"] = np.array(mh_digest(arr.shards[s]), np.int64)
        out[f"d_payload{chunks}_overflow"] = got[3].gather().cpu().numpy()
        del got
    del rows_p, keys_p
    calls: list = []
    build = shuffle_spy(pshuffle, calls)
    try:
        hot_ids = timed("d_hot_ids", lambda: distributed._device_shuffle_ids(mesh, inp["hot_keys"], mesh.size))
    finally:
        pshuffle.build_shuffle = build
    notes["hot_tries"] = [[c["capacity"], c["chunks"], c["overflow"]] for c in calls[: len(calls) // (cfg["reps"] + 1)]]
    for s in mesh.local_shards:
        out[f"d_hot_ids_{s}"] = hot_ids[s]
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # (e) config 3's partitioned join (the engine's fused route over the
    # partitioned attribute side): the search table's join key is its id
    # column (arange), so the winners' keys are their ids
    pk, pi, grp, weight = (mh_put(psearch, mesh, inp[f"parted_{c}"]) for c in ("keys", "rows", "grp", "weight"))
    bounds = np.asarray(inp["parted_bounds"])
    for name, _, metric, k, _, filtered, _, _, agg_obj, _, _ in cfg["joins"]:
        spec = analytics.AggregateSpec.from_dict(agg_obj)
        p_value = weight if analytics._uses_value_col(spec) else None
        int_values = analytics._int_agg_mode(spec, p_value)
        agg = analytics._device_agg(spec)
        fn = psearch.build_serving_search(mesh, k, metric)
        q, (mul, add) = query(f"join_{name}"), aux(metric, filtered)

        def join():
            dist, ids = fn(corpus, q, mul, add)
            parts = analytics._parted_partials(
                mesh, (pk, pi, bounds, cfg["attr_rows"], grp, p_value), ids.reshape(-1).to(torch.int32),
                (ids >= 0).reshape(-1), analytics._winner_values(spec, dist, int_values), agg=agg,
                max_groups=spec.max_groups, int_values=int_values)
            return analytics._merge_parted_tables(parts, spec.max_groups, agg, int_values)

        table = timed(f"e_{name}", join)
        out[f"e_{name}_groups"] = table.column(analytics.GROUP_COL).to_numpy()
        out[f"e_{name}_values"] = table.column(analytics.AGG_COL).to_numpy()
    del pk, pi, grp, weight, auxes, masks

    # (f) the streaming scan: phase 3's rows in chunks, each row-sharded and
    # uploaded per call, merged by (distance, id)
    qn, metric, k, n_chunks = cfg["stream"]
    chunk = n // n_chunks
    c_lo, c_hi = mh_rows(mesh, chunk)
    serving = psearch.build_serving_search(mesh, k, metric)
    q = query("stream")

    def stream():
        dists, gids = [], []
        for start in range(0, n, chunk):
            part = psearch.put_rows(mesh, vec[start + c_lo : start + c_hi], chunk, 0, torch.float32, start=c_lo)
            dist, ids = serving(part, q, *psearch.shard_aux(part, None, metric))
            dists.append(dist)
            gids.append(torch.where(ids >= 0, ids + start, -1))
        return psearch.topk_dist_id(torch.cat(dists, dim=1), torch.cat(gids, dim=1), k)

    dist, ids = timed("f_stream", stream)
    out["f_stream_dist"], out["f_stream_ids"] = dist.cpu().numpy(), ids.cpu().numpy()
    del corpus

    # (g) the dim-sharded search on a (2, 2) mesh: the column partials add in
    # a process, the merge over data rows crosses
    dmesh = mesh.reshape(2)
    corpus_dim, _ = psearch.shard_corpus_dim(dmesh, vec)
    per, m = corpus_dim.rows_local, 2
    _, kd, metrics = cfg["dim"]
    for metric in metrics:
        mul, add = [None] * len(dmesh.grid), [None] * len(dmesh.grid)
        for r, row in enumerate(dmesh.grid):
            if dmesh.is_local(r * m):  # the aux of the full-D rows, before placement
                x = torch.zeros((per, vec.shape[1]), dtype=torch.float32)
                real = vec[r * per : (r + 1) * per]
                x[: real.shape[0]] = ingest.host_tensor(np.ascontiguousarray(real))
                valid = torch.arange(per) < real.shape[0]
                mul[r], add[r] = topk2.prepare_aux(x.to(row[0]), valid.to(row[0]), metric)
                del x
        q_t = torch.from_numpy(np.ascontiguousarray(inp["queries"][f"dim_{metric}"]))
        fn = psearch.build_dim_sharded_search(dmesh, kd, metric)
        args = (corpus_dim, topk2.prepare_queries(q_t, metric).to(lead), mul, add, (q_t.double() ** 2).sum(1).float())
        dist, ids = timed(f"g_dim_{metric}", lambda: fn(*args))
        out[f"g_dim_{metric}_dist"], out[f"g_dim_{metric}_ids"] = dist.cpu().numpy(), ids.cpu().numpy()
    del corpus_dim
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out, times, notes


def multihost_worker(coordinator: str, pid: int, work: str) -> int:
    """One worker of phase 17 (``--multihost-worker``): ``initialize`` with
    the coordinator, its devices from ``work/config.json``, every launch
    count 0, the legs, then its arrays (``proc<pid>.npz``) and its times,
    notes, launches and backend (``proc<pid>.json``) into ``work``."""
    global DEVICE
    import numpy as np
    import torch

    with open(os.path.join(work, "config.json")) as f:
        cfg = json.load(f)
    DEVICE = cfg["device"]
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from fenix_tpu_torch.ops import kernels
    from fenix_tpu_torch.parallel import distributed

    config = distributed.ClusterConfig(coordinator_address=coordinator, num_processes=MH_PROCS, process_id=pid)
    mesh = distributed.initialize(config, devices=cfg["devices"][pid], timeout=MH_INIT_TIMEOUT_S)
    for counts in (kernels.LAUNCHES, kernels.DEVICE_LAUNCHES):
        for key in counts:
            counts[key] = 0
    arrays, times, notes = mh_legs(mesh, mh_inputs(work), cfg)
    launches = {k.removeprefix("bucket_scores."): v for k, v in kernels.LAUNCHES.items()}
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, f"proc{pid}.npz"), **arrays)
    with open(os.path.join(work, f"proc{pid}.json"), "w") as f:
        json.dump({"times": times, "notes": notes, "launches": launches,
                   "card_launches": dict(kernels.DEVICE_LAUNCHES), "backend": mesh.backend,
                   "devices": [str(d) for d in mesh.devices], "local_shards": mesh.local_shards,
                   "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
    return 0


def mh_run_workers(work: str, visible: list) -> float:
    """Start the MH_PROCS workers (this script, ``--multihost-worker``) on a
    free local port and wait for them: a worker that fails, or a pair not
    done within MH_TIMEOUT_S, ends them all and raises with their logs'
    tails. Returns the seconds the pair took."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    t = time.perf_counter()
    try:
        for pid in range(MH_PROCS):
            env = dict(os.environ)
            if visible[pid] is not None:
                env["CUDA_VISIBLE_DEVICES"] = visible[pid]
            logs.append(open(os.path.join(work, f"proc{pid}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost-worker", coordinator, str(pid), work],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=HERE))
        deadline = time.monotonic() + MH_TIMEOUT_S
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    seconds = time.perf_counter() - t
    if any(p.returncode != 0 for p in procs):
        tails = []
        for pid in range(len(procs)):
            with open(os.path.join(work, f"proc{pid}.log")) as f:
                tails.append(f"-- worker {pid}, rc {procs[pid].returncode} --\n{f.read()[-6000:]}")
        raise AssertionError("phase 17: a multihost worker failed or timed out after "
                             f"{seconds:.1f} s\n" + "\n".join(tails))
    return seconds


def mh_compare(results: list, metas: list, want: dict) -> dict:
    """Each worker's arrays against one process's: every replicated array
    on every worker, and each shard's own on its owner, bitwise; the ring's
    blocks concatenated in block order, bitwise."""
    import numpy as np

    checked = 0
    for key, w in want.items():
        if key.startswith("b_ring_"):
            continue
        holders = [r[key] for r in results if key in r]
        owned = key.rsplit("_", 1)[-1].isdigit()
        if len(holders) != (1 if owned else len(results)):
            raise AssertionError(f"multihost {key}: held by {len(holders)} workers")
        for h in holders:
            if h.dtype != w.dtype or h.shape != w.shape or not np.array_equal(h, w):
                raise AssertionError(f"multihost {key}: a worker's differs from one process's")
            checked += 1
    order = sorted(range(len(results)), key=lambda p: metas[p]["notes"]["ring_q_start"])
    for key in ("b_ring_dist", "b_ring_ids"):
        got = np.concatenate([results[p][key] for p in order])
        if got.dtype != want[key].dtype or not np.array_equal(got, want[key]):
            raise AssertionError(f"multihost {key}: the workers' blocks differ from one process's ring")
        checked += 1
    return {"arrays_equal": checked}


def mh_checks(want: dict, notes: dict, metas: list, cfg: dict, inp: dict, vectors, tags) -> list[dict]:
    """The reference's answers (now the workers' too) held to their own
    rules: the payload at chunks 1 and 4 alike and through; the id
    shuffle's placement the host hash's, after an overflow and a retry that
    both workers took in step; the searches, the ring, the stream and the
    dim-sharded search to a float64 oracle over phase 3's rows by phase 4's
    rule."""
    import numpy as np
    import torch

    from fenix_tpu_torch import native

    for key in [k for k in want if k.startswith("d_payload1_")]:
        if not np.array_equal(want[key], want[key.replace("d_payload1_", "d_payload4_")]):
            raise AssertionError(f"multihost payload: chunks=4 differs from chunks=1 at {key}")
    if want["d_payload1_overflow"].any():
        raise AssertionError("multihost payload: a window overflowed at twice the balanced share")
    tries = [m["notes"]["hot_tries"] for m in metas]
    if any(t != notes["hot_tries"] for t in tries) or [t[2] for t in notes["hot_tries"]] != [True, False]:
        raise AssertionError(f"multihost id shuffle: not an overflow, then a retry, in step: {tries}")
    parts, _ = native.hash_partition(np.asarray(inp["hot_keys"]), MH_SHARDS)
    for s in range(MH_SHARDS):
        if not np.array_equal(want[f"d_hot_ids_{s}"], np.flatnonzero(parts == s)):
            raise AssertionError(f"multihost id shuffle: shard {s}'s ids differ from the host hash's")
    del parts
    qs = inp["queries"]
    oracle = Oracle(vectors, DEVICE)
    mask = torch.from_numpy(tags < 50).to(oracle.device)
    cases = [(f"a_{name}", metric, k, precision, qs[f"search_{i}"], filtered, flat is False)
             for i, (name, _, metric, k, precision, filtered, flat) in enumerate(cfg["searches"])]
    _, _, metric, k, precision, filtered, _ = cfg["searches"][2]
    cases.append(("b_ring", metric, k, precision, qs["search_2"], filtered, True))
    _, metric, k, _ = cfg["stream"]
    cases.append(("f_stream", metric, k, "fp32", qs["stream"], False, False))
    cases += [(f"g_dim_{m}", m, cfg["dim"][1], "fp32", qs[f"dim_{m}"], False, False) for m in cfg["dim"][2]]
    rows = []
    for key, metric, k, precision, q, filtered, ties in cases:
        rows.append({"search": f"multihost_{key}", **check_ids(
            oracle, f"multihost_{key}", metric, k, precision, q, want[f"{key}_ids"], want[f"{key}_dist"],
            mask if filtered else None, require_ties=ties)})
    del oracle, mask
    return rows


def phase_multihost(smi: str, kind: str, vectors, tags, queries) -> dict:
    """Phase 17 (see the module docstring): the inputs written once, the
    two workers, then the same legs on one process's mesh of the same four
    shards, every array compared, the answers held to the oracle. Returns
    the workers' launches (the multihost path) and the backend."""
    import numpy as np
    import torch

    from fenix_tpu_torch.parallel.mesh import make_mesh

    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    cfg = mh_config()
    single, cfg["devices"], visible = mh_layout()
    work = os.path.join(HERE, "build", "chip_smoke", f"multihost-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        t = time.perf_counter()
        mh_write_inputs(work, vectors, tags, queries, cfg)
        with open(os.path.join(work, "config.json"), "w") as f:
            json.dump(cfg, f)
        write_s = time.perf_counter() - t
        workers_s = mh_run_workers(work, visible)
        results = [dict(np.load(os.path.join(work, f"proc{p}.npz"))) for p in range(MH_PROCS)]
        metas = []
        for p in range(MH_PROCS):
            with open(os.path.join(work, f"proc{p}.json")) as f:
                metas.append(json.load(f))
        backend = metas[0]["backend"]
        t = time.perf_counter()
        inp = mh_inputs(work)
        want, times, notes = mh_legs(make_mesh(devices=single), inp, cfg)
        single_s = time.perf_counter() - t
        compared = mh_compare(results, metas, want)
        t = time.perf_counter()
        oracle_rows = mh_checks(want, notes, metas, cfg, inp, vectors, tags)
        del inp
        checks_s = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "multihost", "backend": backend, "processes": MH_PROCS, "shards": MH_SHARDS,
          "workers": [{k: m[k] for k in ("devices", "local_shards", "cuda_visible_devices", "backend")}
                      for m in metas],
          "single_process_devices": single, **compared, "write_inputs_s": write_s, "workers_s": workers_s,
          "single_process_s": single_s, "checks_s": checks_s, "device": kind, "nvidia_smi": smi})
    for leg, mine in times.items():
        emit({"phase": "multihost_leg", "leg": leg, "backend": backend,
              "worker_warm_median_ms": [m["times"][leg]["warm_median_ms"] for m in metas],
              "worker_warm_ms": [m["times"][leg]["warm_ms"] for m in metas],
              "worker_first_s": [m["times"][leg]["first_s"] for m in metas],
              "single_process_warm_median_ms": mine["warm_median_ms"], "single_process_warm_ms": mine["warm_ms"],
              "single_process_first_s": mine["first_s"], "clock": "host, synchronised, per process",
              "device": kind, "nvidia_smi": smi})
    for row in oracle_rows:
        emit({"phase": "multihost_oracle", **row})
    per_worker = [{k: m["launches"].get(k, 0) for k in ALL_LAUNCH_KEYS} for m in metas]
    emit({"phase": "multihost_launches", "backend": backend, "per_worker": per_worker,
          "per_worker_card": [m["card_launches"] for m in metas], "device": kind, "nvidia_smi": smi})
    return {"launches": {k: sum(w[k] for w in per_worker) for k in ALL_LAUNCH_KEYS}, "backend": backend}


def kernel_entries(compares: list[dict], by_path: dict) -> list[dict]:
    """One entry of the kernels line per row of KERNELS: its launches on
    each path (it must have some on each path KERNELS names), its largest
    difference from the plain version over every compared shape, and its
    times and bound at the largest shape a main path gave it."""
    entries = []
    for name, key, source, replaces, paths in KERNELS:
        for path in paths:
            if by_path[path][key] == 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        if key == K3_ROUTE:
            mine = [r for r in compares if r["route"] == "f32" and r["bucket"] == 128]
        else:
            mine = [r for r in compares if r["kernel"] == key.removeprefix("kernel.")]
        top = max(mine, key=lambda r: (r.get("search") is not None, r["q"] * r["n"] * r.get("d", D)))
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[key] for c in by_path.values()),
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes" if top["bound_by"] == "read" else "operations",
            "bound_resource": top["bound_by"], "share_of_bound": top["share_of_bound"],
            "library_ms": top["library_ms"],
            "timed_at": {"search": top.get("search"), "route": top["route"], "q": top["q"],
                         "n": top["n"], "d": top.get("d", D), "bucket": top["bucket"]},
        })
    return entries


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # phases 2-14 run on one card (the first) however many the machine has;
    # phase 15 builds its meshes itself and starts its server with auto
    os.environ["FENIX_MESH"] = "off"
    from fenix_tpu_torch import expr
    from fenix_tpu_torch.flight import Flight
    from fenix_tpu_torch.ops import kernels, topk2

    device = DEVICE
    scan_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

    # -- phase 1 --------------------------------------------------------------
    # the rows of phases 3 and 6 are drawn on a host thread (numpy's draws
    # release the GIL) under the build and phases 2-5
    draws = ThreadPoolExecutor(max_workers=1, thread_name_prefix="smoke-draws")
    phase3_data = draws.submit(make_data, ROWS, 0)
    glove_draw = draws.submit(make_data, GLOVE_ROWS, 2, GLOVE_D)
    wide_data = draws.submit(make_data, RES_ROWS, 1, RES_D)
    draws.shutdown(wait=False)
    t = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    lib = str(kernels.build())
    emit({"phase": "device_build", "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "library": lib,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    vectors, ids_np, tags = phase3_data.result()
    queries = [make_queries(vectors, spec[1], seed=10 + i) for i, spec in enumerate(SEARCHES)]
    emit({"phase": "data", "rows": ROWS, "dim": D, "seconds": time.perf_counter() - t})

    # -- phase 2 --------------------------------------------------------------
    t = time.perf_counter()
    small = phase_kernel_vs_plain(kernels, topk2)
    for r in small:
        emit({"phase": "kernel_vs_plain", **r})
    edges = phase_edge_shapes(kernels, topk2)
    emit({"phase": "kernel_vs_plain_edges", **edges})
    wide = phase_kernel_vs_plain_d768(kernels, topk2)
    for r in wide:
        emit({"phase": "kernel_vs_plain_d768", **r})
    forced = phase_forced(kernels, topk2, vectors) + phase_forced_int8(kernels, topk2)
    main_shapes = []
    for spec, qnp in zip(SEARCHES, queries):
        inputs = main_path_inputs(topk2, vectors, tags, spec, qnp, device)
        r = compare(kernels, *inputs)
        main_shapes.append({"search": spec[0], "route": ROUTES[spec[4]], "q": spec[1],
                            "n": ROWS, "bucket": inputs[4], **r})
        emit({"phase": "kernel_vs_plain_main_path", **main_shapes[-1]})
        del inputs
        torch.cuda.empty_cache()
    for i, spec in enumerate(BATCH_SHAPES):
        inputs = main_path_inputs(topk2, vectors, tags, spec, make_queries(vectors, spec[1], seed=700 + i), device)
        r = compare(kernels, *inputs)
        main_shapes.append({"search": spec[0], "route": ROUTES[spec[4]], "q": spec[1],
                            "n": ROWS, "bucket": inputs[4], **r})
        emit({"phase": "kernel_vs_plain_batching_path", **main_shapes[-1]})
        del inputs
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain_done", "seconds": time.perf_counter() - t})

    # -- phase 3 --------------------------------------------------------------
    work = os.path.join(HERE, "build", "chip_smoke", f"run-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    root = os.path.join(work, "root")
    port = free_port()
    proc, log = start_server(root, port, os.path.join(work, "server.log"))
    client = Flight(host="127.0.0.1", port=port)
    try:
        t = time.perf_counter()
        wait_healthy(client, proc)
        before = launches(client)
        if any(before.values()):
            raise AssertionError(f"launch counts not 0 before the main path: {before}")
        emit({"phase": "server_up", "seconds": time.perf_counter() - t})

        put_s = put_items(client, "smoke/items", vectors, ids_np, tags)
        emit({"phase": "put", "rows": ROWS, "batch_rows": BATCH_ROWS, "seconds": put_s})

        results, latencies, first_calls = [], {}, []
        for spec, qnp in zip(SEARCHES, queries):
            name, qn, metric, k, precision, filtered, flat = spec
            kw = dict(metric=metric, maxval=k, precision=precision)
            if filtered:
                kw["filter"] = expr.field("tag") < 50
            target = qnp[0] if flat else qnp
            route = ROUTES[precision]
            # the search's route and the design the dispatcher picks for it
            keys = (route, f"kernel.{kernels.kernel_for(scan_dtypes[precision], qn, D)}")
            t = time.perf_counter()
            c0 = launches(client)
            result = client.search(target, "smoke/items", "vector", **kw)
            c1 = launches(client)
            first = time.perf_counter() - t
            for key in keys:
                if c1[key] <= c0[key]:
                    raise AssertionError(f"{name}: the {key} kernel count did not rise")
            warm = []
            for _ in range(WARM_REPS):
                c0 = launches(client)
                s = time.perf_counter()
                client.search(target, "smoke/items", "vector", **kw)
                warm.append((time.perf_counter() - s) * 1e3)
                c1 = launches(client)
                for key in keys:
                    if c1[key] <= c0[key]:
                        raise AssertionError(f"{name}: the {key} kernel count did not rise")
            latencies[name] = warm
            first_calls.append((name, first))
            results.append(result)
            emit({"phase": "search", "search": name, "q": qn, "k": k, "metric": metric,
                  "precision": precision, "filtered": filtered, "rows_returned": result.num_rows,
                  "first_call_s": first, "launches_after": c1})
        main_launches = launches(client)
        stats = client.stats()
        emit({"phase": "main_path_done", "launches": main_launches,
              "cache_device_bytes": stats.get("cache.device_bytes")})

        # -- phases 3-5, the exact narrow path (glove100) ----------------------
        t = time.perf_counter()
        glove_data = glove_draw.result()
        glove_queries = [make_queries(glove_data[0], spec[1], seed=900 + i) for i, spec in enumerate(GLOVE_SEARCHES)]
        glove = phase_glove_serve(client, expr, kernels, glove_data, glove_queries)
        emit({"phase": "glove_serve_done", "launches": glove["launches"], "seconds": time.perf_counter() - t})

        # -- phase 7 (on the server) ------------------------------------------
        t = time.perf_counter()
        ivf = phase_ivf_serve(client, expr, vectors, root, smi, kind)
        emit({"phase": "ivf_serve_done", "seconds": time.perf_counter() - t})

        # -- phase 8 (on the server) ------------------------------------------
        t = time.perf_counter()
        sel = phase_selection_serve(client, expr, kernels, vectors, tags,
                                    rerun_specs(queries, results, ivf), smi, kind)
        emit({"phase": "selection_serve_done", "launches": sel["launches"],
              "seconds": time.perf_counter() - t})

        # -- phase 11 (on the server) -----------------------------------------
        t = time.perf_counter()
        an = phase_analytics_serve(client, expr, kernels, vectors, smi, kind)
        emit({"phase": "analytics_serve_done", "launches": an["launches"], "seconds": time.perf_counter() - t})

        # -- phase 12 (a)-(d) (on the server) ---------------------------------
        t = time.perf_counter()
        mb = phase_batching_serve(client, Flight, port, expr, vectors, smi, kind)
        emit({"phase": "batching_serve_done", "launches": mb["launches"], "seconds": time.perf_counter() - t})

        # -- phase 13 (on the server) -----------------------------------------
        t = time.perf_counter()
        ty = phase_typed_serve(client, expr, kernels, vectors, ids_np, tags, queries, root, smi, kind)
        emit({"phase": "typed_serve_done", "launches": ty["launches"], "seconds": time.perf_counter() - t})

        # -- phase 10 (a) (on the server) -------------------------------------
        t = time.perf_counter()
        cold_s = next(r for r in first_calls if r[0] == SEARCHES[0][0])[1]
        mut = phase_mutations_serve(client, expr, vectors, ids_np, tags, queries, ivf, cold_s, smi, kind)
        emit({"phase": "mutations_serve_done", "launches": mut["launches"], "seconds": time.perf_counter() - t})
    finally:
        stop_server(client, proc, log, os.path.join(work, "server.log"))
        if sys.exc_info()[0] is not None:  # failing: phase 14 will not read the root
            shutil.rmtree(work, ignore_errors=True)

    # -- phase 14: a traced server on the same root, then the replay ----------
    try:
        t = time.perf_counter()
        trace_dir, query_log = os.path.join(work, "traces"), os.path.join(work, "queries.jsonl")
        port = free_port()
        proc, log = start_server(root, port, os.path.join(work, "server14.log"),
                                 {"FENIX_TRACE_DIR": trace_dir, "FENIX_QUERY_LOG": query_log})
        client = Flight(host="127.0.0.1", port=port)
        try:
            wait_healthy(client, proc)
            phase_tracing_serve(client, expr, vectors, queries, trace_dir, smi, kind)
        finally:
            stop_server(client, proc, log, os.path.join(work, "server14.log"))
        phase_tracing_after(root, query_log, smi, kind)
        torch.cuda.empty_cache()
        emit({"phase": "tracing_done", "seconds": time.perf_counter() - t})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 4 --------------------------------------------------------------
    t = time.perf_counter()
    oracle = Oracle(vectors, device)
    mask = torch.from_numpy(tags < 50).to(device)
    for spec, qnp, result in zip(SEARCHES, queries, results):
        check = check_search(oracle, spec, qnp, result, mask if spec[5] else None)
        emit({"phase": "oracle", "search": spec[0], **check})
    emit({"phase": "oracle_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    glove_rows = phase_glove_checks(kernels, topk2, glove_data, glove_queries, glove)
    del glove_data
    emit({"phase": "glove_done", "seconds": time.perf_counter() - t})

    # -- phase 7 (after the server) -------------------------------------------
    t = time.perf_counter()
    phase_ivf_checks(kernels, topk2, oracle, vectors, tags, ivf, smi, kind)
    emit({"phase": "ivf_done", "seconds": time.perf_counter() - t})

    # -- phase 8 (after the server) -------------------------------------------
    t = time.perf_counter()
    phase_selection_checks(oracle, tags, ivf, sel)
    emit({"phase": "selection_oracle_done", "seconds": time.perf_counter() - t})

    # -- phase 11 (after the server) ------------------------------------------
    t = time.perf_counter()
    phase_analytics_checks(oracle, tags, ivf, an)
    emit({"phase": "analytics_done", "seconds": time.perf_counter() - t})
    del oracle
    torch.cuda.empty_cache()

    # -- phase 13 (after the server) ------------------------------------------
    t = time.perf_counter()
    phase_typed_checks(ty, queries, tags, smi, kind)
    ty_launches = ty["launches"]
    del ty
    torch.cuda.empty_cache()
    emit({"phase": "typed_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    selection_timings(vectors, tags, ivf, smi, kind)
    torch.cuda.empty_cache()
    emit({"phase": "selection_done", "seconds": time.perf_counter() - t})

    # -- phase 12 (after the server): the result gather before and after ------
    gather_timing(vectors, results[[s[0] for s in SEARCHES].index("q1024_l2_k100_filtered")], smi, kind)

    # -- phase 10 (c), the phase-3 table --------------------------------------
    t = time.perf_counter()
    mut_checks = mutation_kernel_checks(kernels, topk2, vectors, tags, queries, mut, smi, kind)
    mut_launches = mut["launches"]
    torch.cuda.empty_cache()
    emit({"phase": "mutation_kernels_done", "seconds": time.perf_counter() - t})

    # -- phase 5 --------------------------------------------------------------
    for spec in (*SEARCHES, *GLOVE_SEARCHES):
        warm = latencies[spec[0]] if spec in SEARCHES else glove["latencies"][spec[0]]
        emit({"phase": "warm_latency", "search": spec[0], "q": spec[1], "k": spec[3],
              "precision": spec[4], "median_ms": float(np.median(warm)),
              "min_ms": float(min(warm)), "all_ms": warm, "device": kind, "nvidia_smi": smi})

    # -- phase 15 (a) and (c): the serving mesh --------------------------------
    ivf_launches, sel_launches, an_launches = ivf["launches"], sel["launches"], an["launches"]
    del results, ivf, sel, mut, an
    t = time.perf_counter()
    mesh = phase_mesh(kernels, topk2, expr, vectors, ids_np, tags, queries, latencies, smi, kind, with_shuffle=True)
    emit({"phase": "mesh_done", "launches": mesh["launches"], "launches_per_card": mesh["card_launches"],
          "analytics_launches": mesh["analytics_launches"],
          "analytics_launches_per_card": mesh["analytics_card_launches"],
          "repartition_launches": mesh["repartition_launches"], "mesh": mesh["mesh"],
          "seconds": time.perf_counter() - t})

    # -- phase 17: multi-host, two processes -----------------------------------
    t = time.perf_counter()
    multihost = phase_multihost(smi, kind, vectors, tags, queries)
    emit({"phase": "multihost_done", "launches": multihost["launches"], "backend": multihost["backend"],
          "seconds": time.perf_counter() - t})
    del vectors, ids_np, tags, queries
    res = phase_residency(kernels, topk2, Flight, expr, smi, kind, wide_data)

    # -- the kernels line ------------------------------------------------------
    compares = small + forced + wide + main_shapes + glove_rows + mut_checks + res["checks"] + mesh["checks"]
    mutation = {k: v + res["mutation_launches"][k] for k, v in mut_launches.items()}
    batching = {k: v + res["batching_launches"][k] for k, v in mb["launches"].items()}
    by_path = {"exact": main_launches, "glove100": glove["launches"], "residency": res["launches"], "ivf": ivf_launches,
               "selection": sel_launches, "mutation": mutation, "analytics": an_launches,
               "batching": batching, "types": ty_launches,
               "mesh": {k: mesh["launches"].get(k, 0) for k in ALL_LAUNCH_KEYS},
               "mesh_analytics": {k: mesh["analytics_launches"].get(k, 0) for k in ALL_LAUNCH_KEYS},
               "repartition": {k: mesh["repartition_launches"].get(k, 0) for k in ALL_LAUNCH_KEYS},
               "multihost": multihost["launches"]}
    entries = kernel_entries(compares, by_path)
    for e in entries:
        emit({"phase": "kernel_timed_at", "name": e["name"], **e.pop("timed_at")})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def run_mesh_only() -> int:
    """Phase 1's build and phases 15 to 17 alone: (a) and (c) on phase 3's
    rows, (b) on phase 6's rows put in process, then phase 16 and phase
    17: the run for a machine with several cards, where the serving mesh
    spans them and phase 17's workers take two cards each (the whole
    script there would repeat phases 2-14 on one card)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from fenix_tpu_torch import expr
    from fenix_tpu_torch.ops import kernels, topk2

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    t = time.perf_counter()
    emit({"phase": "device_build", "device": kind, "nvidia_smi": smi, "cards": torch.cuda.device_count(),
          "library": str(kernels.build()), "seconds": time.perf_counter() - t})
    vectors, ids_np, tags = make_data(ROWS, seed=0)
    queries = [make_queries(vectors, spec[1], seed=10 + i) for i, spec in enumerate(SEARCHES)]
    t = time.perf_counter()
    mesh = phase_mesh(kernels, topk2, expr, vectors, ids_np, tags, queries, {}, smi, kind, with_shuffle=True)
    emit({"phase": "mesh_done", "launches": mesh["launches"], "launches_per_card": mesh["card_launches"],
          "analytics_launches": mesh["analytics_launches"],
          "analytics_launches_per_card": mesh["analytics_card_launches"],
          "repartition_launches": mesh["repartition_launches"], "mesh": mesh["mesh"],
          "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    multihost = phase_multihost(smi, kind, vectors, tags, queries)
    emit({"phase": "multihost_done", "launches": multihost["launches"], "backend": multihost["backend"],
          "seconds": time.perf_counter() - t})
    for name, key, *_ in KERNELS:
        for path, counts in (("mesh", mesh["launches"]), ("mesh_analytics", mesh["analytics_launches"]),
                             ("repartition", mesh["repartition_launches"]), ("multihost", multihost["launches"])):
            if path in _[-1] and not counts.get(key):
                raise AssertionError(f"{name} was not launched on the {path} path")
    del vectors, ids_np, tags, queries

    import pyarrow as pa

    from fenix_tpu_torch.io import ingest, table

    t = time.perf_counter()
    vectors, ids_np, tags = make_data(RES_ROWS, seed=1, dim=RES_D)
    pool = np.flatnonzero((tags[:DUP] < 50) & (tags[DUP : 2 * DUP] < 50))
    queries = {q: make_queries(vectors, q, seed=100 + q, src_pool=pool) for q in (8, 1024)}
    work = os.path.join(HERE, "build", "chip_smoke", f"residency-{os.getpid()}")
    try:
        schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), RES_D), "tag": pa.int32()})
        table.make(os.path.join(work, "root"), "smoke/wide", pa.RecordBatchReader.from_batches(schema, (
            pa.record_batch([pa.array(ids_np[s : s + BATCH_ROWS]),
                             ingest.numpy_to_fixed_size_list(vectors[s : s + BATCH_ROWS], pa.float32()),
                             pa.array(tags[s : s + BATCH_ROWS])], schema=schema)
            for s in range(0, RES_ROWS, BATCH_ROWS))))
        res = phase_mesh_residency(os.path.join(work, "root"), Live(vectors, ids_np, tags), queries, smi, kind)
        emit({"phase": "mesh_residency_done", "mesh": res["mesh"], "seconds": time.perf_counter() - t})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh-only", action="store_true",
                        help="phase 1's build and phases 15 to 17 alone (a machine with several cards)")
    parser.add_argument("--multihost-worker", nargs=3, metavar=("COORDINATOR", "PROCESS_ID", "WORK_DIR"),
                        help="one worker process of phase 17 (the script starts these itself)")
    args = parser.parse_args()
    try:
        if args.multihost_worker:
            coordinator, pid, work = args.multihost_worker
            return multihost_worker(coordinator, int(pid), work)
        return run_mesh_only() if args.mesh_only else run()
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
