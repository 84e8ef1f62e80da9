"""The benchmark's plain reference: what the port must compute, in plain PyTorch.

Frozen copies, made from the port at commit d7fbb27, of the plain (non-kernel)
arithmetic of ``sgmse_tpu_torch``: the STFT and compression transforms
(``dsp.py``), the OUVE and SBVE SDEs (``sdes.py``), the PC and
Schroedinger-bridge samplers (``sampling.py``), the flagship NCSN++ with its
FIR resampling and GroupNorm (``models/ncsnpp.py``, ``models/blocks.py``,
``ops/upfirdn2d.py:upfirdn2d_plain``, ``ops/group_norm.py:group_norm_act_plain``)
and the differentiable PESQ loss (``utils/pesq_loss.py``). Each module says
what it copies. They import nothing of ``sgmse_tpu_torch`` and nothing of JAX,
and take from the program nothing but the outputs they judge: weights, inputs
and noise come from the benchmark, which hands the same to both sides.

Products (convolutions, dense layers, matmuls) go through :mod:`.lowp`, so the
same code runs in float32 with TF32 off (the reference) and in a lower
precision (the control that has to fail the comparison).
"""
