"""FFT sizes for the NCC correlation (``ops/ncc.py``).

Linear correlation through a circular FFT needs a transform of at least
``image + template - 1`` per axis; the size is rounded up to a small-radix
``2^a * 3^b * 5^c`` with ``a >= 2``, biased toward powers of two. These are
the JAX package's sizes (``shoeprint_image_retrieval_tpu/ops/fft.py``), so
both packages transform on the same canvas; cuFFT is fast on such sizes too.
"""

from __future__ import annotations


def next_fast_fft_size(n: int) -> int:
    """Smallest size >= n among 2^k, 3*2^k, 5*2^k, 9*2^k and 15*2^k (k >= 2),
    and 4 for n <= 4."""
    if n <= 4:
        return 4
    best = 1
    while best < n:
        best *= 2
    cands = [best]
    for mult in (3, 5, 9, 15):
        k = 4
        while mult * k < n:
            k *= 2
        cands.append(mult * k)
    return min(c for c in cands if c >= n)


def correlation_fft_shape(image_hw: tuple[int, int], template_hw: tuple[int, int]) -> tuple[int, int]:
    """FFT canvas for alias-free linear correlation of the given canvases."""
    return (
        next_fast_fft_size(image_hw[0] + template_hw[0] - 1),
        next_fast_fft_size(image_hw[1] + template_hw[1] - 1),
    )
