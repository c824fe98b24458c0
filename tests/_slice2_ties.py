"""Where the port's greedy tokens leave JAX's in the ``slice2`` configuration
of ``tests/test_torch_slice.py``, and why. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/_slice2_ties.py

Prints (1) the greedy flips, (2) the per-step replay the greedy test holds
(the port's step run from JAX's cache at every step: each logit row outside
2e-3 + 2e-3·|ref| and the int8 rounding within ``TIE_ULPS`` ulps of its tie
that brings it back), and (3) the same steps with the port on its own cache
(teacher-forced on JAX's tokens from JAX's prompt cache): each step whose
appended int8 bytes differ from JAX's, how many, and how far the farthest
unquantized value lies from a .5 tie.
"""

import itertools
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
jax.config.update("jax_platforms", "cpu")

import test_torch_slice as ts  # noqa: E402


class _Dirs:
    """``tmp_path_factory`` for ``make_runtimes`` outside pytest."""

    def __init__(self, root):
        self.root, self.n = pathlib.Path(root), itertools.count()

    def mktemp(self, name):
        path = self.root / f"{name}{next(self.n)}"
        path.mkdir()
        return path


def main():
    from vocalie_tts_tpu.models.common import transformer as jtr
    from vocalie_tts_tpu_torch.models.common import transformer as ptr

    with tempfile.TemporaryDirectory() as tmp:
        runtimes = ts.make_runtimes("slice2", _Dirs(tmp))
        jrt, prt, _ = next(runtimes)
        texts = ts._texts()
        jt, _ = ts._jax_generate(jrt, texts, **ts.GREEDY)
        pt, _ = ts._port_generate(prt, texts, **ts.GREEDY)
        flips = {r: int(np.argmax(jt[r] != pt[r])) for r in range(jt.shape[0])
                 if (jt[r] != pt[r]).any()}
        print(f"greedy flips (row: step): {flips}")
        n = max(flips.values(), default=0) + 1
        for step, row, ratio, call, elem, ulps, after in ts._replay_up_to_ties(
                jrt, prt, texts, jt, n):
            print(f"replay from JAX's cache, step {step} row {row}: {ratio:.2f}x the gate; "
                  f"rounding #{call} element {elem}, {ulps:.0f} ulps from its tie, taken the "
                  f"other way: {after:.2e}x")

        # the port on its own cache, teacher-forced on JAX's tokens
        kw = dict(mode="fr_finetune", lang="fr", exaggeration=0.5,
                  cfg_weight=ts.GREEDY["cfg_weight"])
        t3, embeds, lens, (_, _, _, cache_len) = jrt._prepare_batch(texts, voice_ref_path=None,
                                                                     **kw)
        _, jc = jtr.prefill(t3["lm"], jrt.cfg.lm, jnp.zeros(embeds.shape[:2], jnp.int32), lens,
                            inputs_embeds=embeds, cache_len=cache_len)
        pt3, pembeds, plens, _ = prt._prepare_batch(texts, **kw)
        _, pc = ptr.prefill(pt3["lm"], prt.cfg.lm, None, plens, inputs_embeds=pembeds,
                            cache_len=cache_len)
        d = pc.k.shape[-1]
        jk = np.asarray(jc.k)
        for name, val in (("k", jk[..., :d]), ("v", jk[..., d:])):
            getattr(pc, name).copy_(torch.from_numpy(np.array(val)))
            getattr(pc, name + "_scale").copy_(torch.from_numpy(np.array(
                getattr(jc, name + "_scale").astype(jnp.float32))).to(torch.bfloat16))
        step = jax.jit(lambda p, t, c: jtr.decode_step(p, jrt.cfg.lm, t, c))
        raw, quantize = [], ptr._quantize_kv
        ptr._quantize_kv = lambda t: raw.append(t.clone()) or quantize(t)
        tok = np.full((2 * jt.shape[0],), jrt.cfg.bos_speech, np.int32)
        try:
            for i in range(n):
                _, jc = step(t3["lm"], jnp.asarray(tok), jc)
                ptr.decode_step(pt3["lm"], prt.cfg.lm, torch.from_numpy(tok).long(), pc)
                pos = pc.prompt_pad + i
                jks = np.asarray(jc.k[:, :, :, pos])
                for name, ref, unq in (("k", jks[..., :d], raw[-2]), ("v", jks[..., d:], raw[-1])):
                    got = getattr(pc, name)[:, :, :, pos].numpy()
                    scale = getattr(pc, name + "_scale")[:, :, :, pos]
                    jscale = np.asarray(getattr(jc, name + "_scale")[:, :, :, pos])
                    bad = got != ref
                    if not bad.any():
                        continue
                    x = (unq / scale.float()[..., None]).numpy()[bad]
                    far = np.abs(np.abs(x - np.trunc(x)) - 0.5).max()
                    rows = sorted({int(r) for r in np.nonzero(bad)[1]})
                    same_scale = np.array_equal(scale.view(torch.int16).numpy(),
                                                jscale.view(np.int16))
                    print(f"own cache, step {i}: {int(bad.sum())} {name} bytes differ (rows "
                          f"{rows}, scales equal {same_scale}), farthest {far:.4f} from a tie")
                tok = np.concatenate([jt[:, i], jt[:, i]])
        finally:
            ptr._quantize_kv = quantize


if __name__ == "__main__":
    main()
