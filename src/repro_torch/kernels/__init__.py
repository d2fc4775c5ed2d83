"""Hand-written CUDA kernels of the main path, each beside its plain version.

  neumann  fused batched Neumann propagation hops: every traffic and
           cost-to-go fixed point (csrc/neumann.cu)
  minplus  batched tropical (min,+) product and its fused first-minimum
           argmin: APSP squaring and the next-hop table (csrc/minplus.cu)

Each package ships ops.py (wrapper: CUDA tensor -> kernel, CPU tensor ->
plain version) and ref.py (the plain PyTorch versions). `_build` compiles
the CUDA sources at first use and holds the launch counts.
"""
