"""Command-line tools of keto_tpu_torch.

  microbench              the check kernel's irregular primitives (gather,
                          scatter-max, stream compaction, double-hash
                          probe) timed alone on the card: M1-M7
  microbench_feasibility  three probes of what a kernel can do on the card
                          (an add, a vector row gather, a block gather):
                          M8-M10

Each runs on the card unless given --device cpu, where the plain PyTorch
versions run instead:

    python -m keto_tpu_torch.tools.microbench [--device cpu] [--n 50]
    python -m keto_tpu_torch.tools.microbench_feasibility [--device cpu]
"""
