"""``tests/test_torch_slice.py``'s tests in the ``slice2`` configuration:
the JAX package's default int8 serving configuration (the dense kernels
B2-B4 on) on a ``tiny`` T3 widened to d_model 128. A file of its own, so
that ``--dist loadfile`` runs it on another worker than ``slice1``; the
tests and their tolerances are that file's."""

import pytest
from test_torch_slice import (  # noqa: F401  (collected here with this file's fixture)
    greedy,
    make_runtimes,
    one_torch_thread,
    test_greedy_tokens_match,
    test_run_tts_pipeline_matches,
    test_stage2_pcm_on_jax_tokens,
)


@pytest.fixture(scope="module", params=["slice2"])
def runtimes(request, tmp_path_factory):
    yield from make_runtimes(request.param, tmp_path_factory)
