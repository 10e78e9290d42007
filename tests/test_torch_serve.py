"""The port's serving driver (``repro_torch.launch.serve``) on the CPU,
at smoke sizes: the reference's batcher answers every request with
``max_new`` tokens for every token-input family (dense, moe, hybrid,
ssm), and the PATS estimates come from an H100 lane."""

import pytest

from repro_torch.core.cost_model import TPU_V5E, LaneModel
from repro_torch.launch import serve
from repro_torch.launch.costs_h100 import H100_SXM


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen1.5-4b", "dbrx-132b", "arctic-480b",
                                  "xlstm-125m"])
def test_serve_requests_answers_every_request(arch):
    out = serve.serve_requests(arch=arch, smoke=True, n_requests=5, batch_size=2,
                               prompt_len=16, max_new=4, max_len=32, device="cpu")
    assert out["requests"] == 5
    assert out["tokens"] == 5 * 4
    assert out["steps"] == {"prefill": 3, "decode": 3 * 3}
    assert out["device"] == "cpu"
    assert out["tokens_per_s"] > 0 and out["mean_ttft_s"] > 0
    assert out["mean_decode_step_s"] > 0
    s_pre, s_dec = out["pats_estimates"]["prefill"], out["pats_estimates"]["decode"]
    assert s_pre > s_dec > 0  # prefill is the compute-bound, high-speedup op


def test_serve_is_deterministic_per_seed():
    run = lambda seed: serve.serve_requests(  # noqa: E731
        arch="qwen1.5-4b", n_requests=2, batch_size=2, prompt_len=8, max_new=3,
        max_len=16, seed=seed, device="cpu")
    a, b = run(0), run(0)
    assert a["tokens"] == b["tokens"] == 6


def test_serve_rejects_a_cache_too_short():
    with pytest.raises(ValueError, match="max_len"):
        serve.serve_requests(prompt_len=30, max_new=8, max_len=32, device="cpu")


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_serve_rejects_an_embedding_frontend(arch):
    """audio and vlm read precomputed embeddings; the batcher builds token
    prompts, as the reference's (``Model.prefill`` serves them)."""
    with pytest.raises(ValueError, match="embeddings"):
        serve.serve_requests(arch=arch, n_requests=2, batch_size=2, prompt_len=8,
                             max_new=2, max_len=16, device="cpu")


def test_pats_estimates_use_the_h100_lane():
    assert isinstance(H100_SXM, LaneModel) and H100_SXM is not TPU_V5E
    assert H100_SXM.peak_flops == 989e12 and H100_SXM.mem_bw == 3.35e12
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("zamba2-1.2b")
    s_pre, s_dec = serve._speedups(cfg, 4, 1024, 2048)
    from repro_torch.core.cost_model import OpCost, estimate_speedup

    n = cfg.active_params()
    want = estimate_speedup(OpCost(flops=2 * n * 4 * 1024,
                                   bytes=2 * n + 4 * 1024 * cfg.d_model * 2), H100_SXM)
    assert s_pre == pytest.approx(want)
    assert s_dec < s_pre


def test_serve_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "zamba2-1.2b", "--requests", "2",
                                     "--batch", "2", "--prompt-len", "8", "--max-new", "2",
                                     "--max-len", "16", "--device", "cpu"])
    serve.main()
    assert "[serve] 2 requests, 4 tokens" in capsys.readouterr().out
