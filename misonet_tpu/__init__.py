"""misonet_tpu — multi-microphone complex spectral mapping framework in JAX.

A from-scratch JAX/XLA implementation of the MISO1 -> MVDR -> MISO2/3
speech-separation cascade of Wang et al. 2021 ("Multi-microphone Complex
Spectral Mapping for Utterance-wise and Continuous Speech Separation",
IEEE/ACM TASLP vol. 29; arXiv 2010.01703), with the same capabilities as the
PyTorch reference implementation (yuhogun0908/MISOnet), running on one or
more NVIDIA GPUs (or the CPU, for tests):

  * framed-FFT STFT/iSTFT on device, matching scipy.signal.stft semantics
    (reference: dataloader/data.py:49-66, tester.py:186-198)
  * MISO U-Net/TCN separation + enhancement nets as XLA convolutions
    (reference: model.py)
  * utterance-level PIT losses as vectorized permutation einsums
    (reference: criterion.py)
  * batched on-device MVDR beamforming — SCM estimation, power-iteration
    steering, associative-scan phase correction, Hermitian solves
    (reference: tester.py:637-794)
  * data-parallel training over a jax.sharding.Mesh with psum gradient
    reduction (new capability; the reference is single-GPU).
"""

__version__ = "0.1.0"
