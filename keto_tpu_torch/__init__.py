"""keto_tpu_torch — keto-tpu's Check and Expand paths in PyTorch, for one
NVIDIA H100.

The port of the JAX package `keto_tpu` (the reference it is tested
against): tuples go into a store, a snapshot compiles them into packed
hash tables, a CSR edge pack and rewrite programs, the tables live on the
card, and batches of checks run as a breadth-first walk whose hot phases
are hand-written CUDA kernels (csrc/check_kernels.cu). AND/NOT islands
combine on the host, and flagged queries replay on the exact host oracle.
Expand walks a full-edge CSR breadth-first on the card, gathering each
query's edges into a packed pool (csrc/expand_kernels.cu), and the host
assembles the trees.

Layout:
  ketoapi     — relation tuples, subject sets, string and JSON forms
  namespace   — namespace model and rewrite AST
  config      — JSON configuration of the Check path
  storage     — in-memory versioned tuple store
  engine      — snapshot compiler, host oracle, check and expand kernels,
                the engine
  api         — REST server (Check, batch Check and Expand)

Entry points run on the card (device="cuda") unless the caller passes
device="cpu", where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"
