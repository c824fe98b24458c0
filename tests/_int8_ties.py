"""Holding the port to the JAX package up to int8 rounding ties.

An int8 quantizer rounds ``x / scale`` half to even. The two packages'
f32 means, rsqrt and exp differ in the last ulp, so a value that sits on a
.5 tie may round one way in JAX and the other in the port: one int8 step
apart. Two kinds show in the parity tests:

- a cache byte the decode step appends (``assert_appended_cache_up_to_ties``):
  off by one, its unquantized value within 1e-3 of a .5 tie;
- an activation the dense kernels quantize inside a step
  (``assert_step_rows_up_to_ties``): the step's logit row leaves the
  2e-3 + 2e-3·|ref| gate, and rounding one value of that row within
  ``TIE_ULPS`` ulps of its tie the other way brings it back within the gate.

Anything else (a differing byte away from a tie, a logit row no single tie
explains) fails.
"""

import numpy as np
import torch

#: a rounding whose pre-round value lies within TIE_ULPS f32 ulps of its .5
#: tie may go either way between the two packages (chip_smoke.py holds the
#: GPU against the CPU to the same count)
TIE_ULPS = 64


def assert_appended_cache_up_to_ties(jcache, pcache, raw, prompt_pad=32):
    """The decode slots of the int8 cache: bf16 scales equal; layer 0's
    int8 values equal; the later layers' equal except where the port's
    unquantized value (``raw``: its k and v of each step, [L, b, kv, d])
    sits on a .5 tie, one step off."""
    n = len(raw) // 2
    sl = slice(prompt_pad, prompt_pad + n)
    d = pcache.k.shape[-1]
    jk = np.asarray(jcache.k)[:, :, :, sl]
    jv = jk[..., d:] if jcache.v is None else np.asarray(jcache.v)[:, :, :, sl]
    for name, ref, unq in (("k", jk[..., :d], raw[0::2]), ("v", jv, raw[1::2])):
        scale = getattr(pcache, name + "_scale")[:, :, :, sl]
        jscale = np.asarray(getattr(jcache, name + "_scale"))[:, :, :, sl]
        assert np.array_equal(scale.view(torch.int16).numpy(), jscale.view(np.int16)), name
        got = getattr(pcache, name)[:, :, :, sl].numpy()
        assert np.array_equal(got[0], ref[0]), f"layer 0 {name}"
        bad = got != ref
        if not bad.any():
            continue
        assert np.all(np.abs(got[bad].astype(int) - ref[bad].astype(int)) == 1), name
        x = (torch.stack(unq, 3) / scale.float()[..., None]).numpy()[bad]
        assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"


def ulps_from_tie(x: torch.Tensor) -> np.ndarray:
    """Distance of f32 values from the nearest .5, in f32 ulps of each."""
    a = np.abs(x.detach().float().numpy().astype(np.float32))
    frac = a.astype(np.float64) - np.floor(a.astype(np.float64))
    return np.abs(frac - 0.5) / np.spacing(a).astype(np.float64)


def _row_of(t: torch.Tensor, r: int, b: int) -> torch.Tensor:
    """Batch row ``r`` of a rounded tensor: along its first dim whose size
    is a multiple of ``b`` (the dense kernels' [b, n] rows; the decode
    attention's rows merged with their heads)."""
    for dim, n in enumerate(t.shape):
        if n % b == 0:
            return t.narrow(dim, r * (n // b), n // b)
    return t


class _Rounds:
    """``torch.round`` for one run: records each call's input (``trace``)
    and rounds element ``flip[1]`` (flat) of call ``flip[0]`` the other
    way."""

    def __init__(self, trace=None, flip=None):
        self.trace, self.flip, self.calls = trace, flip, 0

    def __enter__(self):
        self._round = torch.round

        def rounded(x, *a, **k):
            out = self._round(x, *a, **k)
            if self.trace is not None:
                self.trace.append(x.detach().clone())
            if self.flip is not None and self.flip[0] == self.calls:
                out = out.clone()
                flat, e = out.view(-1), self.flip[1]
                flat[e] += 1.0 if x.reshape(-1)[e] > flat[e] else -1.0
            self.calls += 1
            return out

        torch.round = rounded
        return self

    def __exit__(self, *exc):
        torch.round = self._round


def _gate(got, ref) -> np.ndarray:
    """Each row's worst |got - ref| / (2e-3 + 2e-3·|ref|)."""
    return (np.abs(got - ref) / (2e-3 + 2e-3 * np.abs(ref))).max(-1)


def assert_step_rows_up_to_ties(step, ref, label: str) -> list:
    """``step()`` runs one decode step of the port from the reference's
    state and returns its logits [b, vocab] as numpy; ``ref`` is JAX's.
    Every row within 2e-3 + 2e-3·|ref|, or brought within it by rounding
    one of that row's values within ``TIE_ULPS`` ulps of its .5 tie the
    other way (any ``torch.round`` of the step: the dense kernels' and the
    decode attention's quantizers). Returns, for each row that needed a
    tie, (row, its ratio to the gate, the rounding call, the element, its
    ulps from the tie, the ratio once flipped)."""
    trace = []
    with _Rounds(trace=trace):
        ratio = _gate(step(), ref)
    b = ref.shape[0]
    shown = []
    for r in np.nonzero(ratio > 1)[0].tolist():
        found = None
        for c, x in enumerate(trace):
            index = _row_of(torch.arange(x.numel()).reshape(x.shape), r, b).reshape(-1)
            ulps = ulps_from_tie(x.reshape(-1)[index])
            for e, u in zip(index[torch.from_numpy(ulps <= TIE_ULPS)].tolist(),
                            ulps[ulps <= TIE_ULPS].tolist()):
                with _Rounds(flip=(c, e)):
                    after = _gate(step(), ref)[r]
                if after <= 1:
                    found = (r, float(ratio[r]), c, e, u, float(after))
                    break
            if found:
                break
        assert found, (f"{label}: logit row {r} is {ratio[r]:.2f}x the gate, and no single "
                       f"rounding within {TIE_ULPS} ulps of its tie explains it")
        shown.append(found)
    return shown
