"""The two prime fields of ristretto255, and multilinear helpers over the
scalar field."""

from __future__ import annotations

P = 2**255 - 19  # coordinate field
Q = 2**252 + 27742317777372353535851937790883648493  # group order

R_INV = pow(1 << 256, -1, Q)  # Montgomery radix 2^256, inverted mod q


def inv(x: int, m: int = Q) -> int:
    if x % m == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(x, -1, m)


def batch_inv(xs: list[int]) -> list[int]:
    """Inverses mod q of non-zero ``xs`` by one inversion."""
    prefix = [1]
    for x in xs:
        if x % Q == 0:
            raise ZeroDivisionError("inverse of zero")
        prefix.append(prefix[-1] * x % Q)
    acc = inv(prefix[-1])
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * acc % Q
        acc = acc * xs[i] % Q
    return out


def eq_table(r: list[int]) -> list[int]:
    """eq(r, x) for every x in {0,1}^len(r), the first variable the most
    significant bit of x."""
    tab = [1]
    for rj in r:
        nxt = []
        app = nxt.append
        for t in tab:
            hi = t * rj % Q
            app((t - hi) % Q)
            app(hi)
        tab = nxt
    return tab


def eq_eval(a: list[int], b: list[int]) -> int:
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % Q) % Q
    return acc


def fold_low(vals: list[int], rs: list[int]) -> int:
    """The multilinear extension of ``vals`` at ``rs``, the variables
    taken from the last (the least significant bit) first."""
    cur = [v % Q for v in vals]
    for r in reversed(rs):
        cur = [(cur[2 * k] + r * (cur[2 * k + 1] - cur[2 * k])) % Q
               for k in range(len(cur) // 2)]
    return cur[0]


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def log2(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()
