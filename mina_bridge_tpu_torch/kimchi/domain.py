"""Radix-2 evaluation domains over the Pasta scalar fields (host ints).

Counterpart of mina_bridge_tpu/kimchi/domain.py: the domain constants
(omega, its inverse, 1/n), the inverse FFT the verifier index uses to
build Lagrange-basis coefficients, and the forward FFT (the host oracle of
ops/ntt.py).
"""

from __future__ import annotations

import dataclasses
import functools

from ..fields.params import TWO_ADICITY, FieldSpec


@dataclasses.dataclass(frozen=True)
class Domain:
    field: FieldSpec
    log_size: int

    @property
    def n(self) -> int:
        return 1 << self.log_size

    @functools.cached_property
    def omega(self) -> int:
        """Primitive n-th root of unity."""
        from ..curves.host import _least_generator

        p = self.field.p
        root = pow(_least_generator(self.field), self.field.trace, p)  # order 2^32
        for _ in range(TWO_ADICITY - self.log_size):
            root = root * root % p
        assert pow(root, self.n, p) == 1 and pow(root, self.n // 2, p) != 1
        return root

    @functools.cached_property
    def omega_inv(self) -> int:
        return pow(self.omega, self.field.p - 2, self.field.p)

    @functools.cached_property
    def n_inv(self) -> int:
        return pow(self.n, self.field.p - 2, self.field.p)


def _ntt(a: list[int], root: int, p: int) -> list[int]:
    """Iterative radix-2 NTT (bit-reversed input order, natural output)."""
    n = len(a)
    a = list(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, p)
        half = length // 2
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w_len % p
        for start in range(0, n, length):
            for i in range(half):
                u, v = a[start + i], a[start + i + half] * ws[i] % p
                a[start + i] = (u + v) % p
                a[start + i + half] = (u - v) % p
        length <<= 1
    return a


def fft(dom: Domain, coeffs: list[int]) -> list[int]:
    """Coefficients -> evaluations on H (padded/truncated to n)."""
    p = dom.field.p
    a = [c % p for c in coeffs[: dom.n]] + [0] * max(0, dom.n - len(coeffs))
    return _ntt(a, dom.omega, p)


def ifft(dom: Domain, evals: list[int]) -> list[int]:
    """Evaluations on H -> coefficients."""
    p = dom.field.p
    a = _ntt([e % p for e in evals], dom.omega_inv, p)
    return [c * dom.n_inv % p for c in a]
