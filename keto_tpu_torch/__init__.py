"""keto_tpu_torch — keto-tpu's Check path in PyTorch, for one NVIDIA H100.

The port of the JAX package `keto_tpu` (the reference it is tested
against): tuples go into a store, a snapshot compiles them into packed
hash tables, a CSR edge pack and rewrite programs, the tables live on the
card, and batches of checks run as a breadth-first walk whose hot phases
are hand-written CUDA kernels (csrc/check_kernels.cu). AND/NOT islands
combine on the host, and flagged queries replay on the exact host oracle.

Layout:
  ketoapi     — relation tuples, subject sets, string and JSON forms
  namespace   — namespace model and rewrite AST
  config      — JSON configuration of the Check path
  storage     — in-memory versioned tuple store
  engine      — snapshot compiler, host oracle, check kernel and engine
  api         — REST server (Check and batch Check)

Entry points run on the card (device="cuda") unless the caller passes
device="cpu", where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"
