"""keto_tpu_torch — keto-tpu's Check, Expand, List and Filter paths in
PyTorch, for one NVIDIA H100.

The port of the JAX package `keto_tpu` (the reference it is tested
against): tuples go into a store, a snapshot compiles them into packed
hash tables, a CSR edge pack and rewrite programs, the tables live on the
card, and batches of checks run as a breadth-first walk whose hot phases
are hand-written CUDA kernels (csrc/check_kernels.cu). AND/NOT islands
combine on the host, and flagged queries replay on the exact host oracle.
Expand walks a full-edge CSR breadth-first on the card, gathering each
query's edges into a packed pool (csrc/expand_kernels.cu), and the host
assembles the trees. ListObjects walks a transposed mirror backwards and
ListSubjects the full-edge CSR forwards with the rewrites, each emitting
its results into a packed pool (csrc/list_kernels.cu) that the host
decodes. With the Leopard closure index on, a check batch is one probe
launch over the powered closure sets whatever the chain depth, and
BatchFilter answers a column of candidates for one subject through that
probe or one shared reverse walk that marks them
(csrc/closure_filter_kernels.cu). A write marks the closure nodes it may
change dirty, and the closure maintainer powers them again.

Layout:
  ketoapi     — relation tuples, subject sets, string and JSON forms
  namespace   — namespace model and rewrite AST
  config      — JSON configuration of the read paths
  storage     — versioned tuple stores: in memory, columnar, and the
                durable SQLite store with its changelog
  faults      — named fault points (KETO_FAULTS) for tests and drills
  engine      — snapshot compiler, host oracle, check, expand, list,
                closure and filter kernels, the closure index, the engine
  closure     — the closure maintainer: keeps each engine's index fresh
  resilience  — deadlines, admission, the device-path circuit breaker
  registry    — the serving plane's composition root (store, engine,
                check cache, breaker, readiness)
  api         — the REST routes (Check, batch Check, Expand, List, Filter,
                the tuple list and the writes) and their OpenAPI document,
                the gRPC services over the runtime descriptors and their
                clients, the check batcher, the check cache and the daemon
                (REST and gRPC on one port through its mux)

Entry points run on the card (device="cuda") unless the caller passes
device="cpu", where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"
