"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``) on
the smoke config: it completes every request, with and without the int8
KV cache, and draws its request mix as the reference's launcher does."""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which repro.core's
# graph_sim imports; alias it before the first repro import
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro_torch.launch import serve


@pytest.mark.parametrize("extra", ([], ["--kv8"], ["--technique", "gss,2"]))
def test_serve_completes_all_requests_on_cpu(capsys, extra):
    rc = serve.main(["--arch", "qwen3-4b", "--requests", "6", "--slots", "2",
                     "--max-len", "32", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert "completed=6/6" in out and "device=cpu" in out


def test_request_mix_is_drawn_as_the_reference_draws_it():
    # src/repro/launch/serve.py draws prompt_len then max_new_tokens per
    # request from default_rng(seed)
    rng = np.random.default_rng(3)
    want = [(int(rng.integers(4, 64 // 4)), int(rng.integers(4, 64 // 4)))
            for _ in range(5)]
    got = serve.make_requests(5, 64, 3)
    assert [(r.prompt_len, r.max_new_tokens) for r in got] == want
    assert [r.rid for r in got] == list(range(5))


def test_replicas_wait_for_the_cluster_slice():
    with pytest.raises(NotImplementedError, match="serve/cluster.py"):
        serve.main(["--arch", "qwen3-4b", "--replicas", "2", "--device", "cpu"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b", "--requests", "1"])
