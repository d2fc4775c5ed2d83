"""Hand-written CUDA kernels, each beside its plain version.

  neumann  fused batched Neumann propagation hops: every traffic and
           cost-to-go fixed point (csrc/neumann.cu)
  minplus  batched tropical (min,+) product and its fused first-minimum
           argmin: APSP squaring and the next-hop table (csrc/minplus.cu)
  flash_attention
           streaming-softmax attention (GQA, causal, sliding window) of the
           model substrate's prefill and forward (csrc/flash_attention.cu);
           its gradient is the plain backward (ops.flash_attention_backward)
  placement
           the sequential placement sweep, one CTA a lane walking its apps
           and partitions in order (csrc/placement.cu)
  forwarding
           one forwarding sweep's update of phi, each row's marginals,
           minimum, decay and reassignment in a warp's registers
           (csrc/forwarding.cu)
  phi_contract
           the cost-to-go's two contractions of phi, the link loads F and
           the link term, each one launch reading phi once
           (csrc/phi_contract.cu)

Each package ships ops.py (wrapper: CUDA tensor -> kernel, CPU tensor ->
plain version) and ref.py (the plain PyTorch versions). `_build` compiles
the CUDA sources at first use and holds the launch counts.
"""
