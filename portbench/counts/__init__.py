"""The benchmark's frozen yardstick: peaks, kernel bounds and network FLOPs.

- :mod:`.peaks`: the H100 SXM's published peaks;
- :mod:`.kernels`: bytes and operations of K1, its adjoint, K2, K2b and K6
  per call signature, and the bound they set;
- :mod:`.network`: the convolution and matmul FLOPs of a network forward at
  an input shape, counted from the plain reference's shapes.

Each counts the layer's work from its shapes, whatever code computes it.
"""
