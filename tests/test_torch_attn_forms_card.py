"""Decode attention (K2, K6, K8, K9) at a cache head_dim above 128 and at
more than 8 query heads per KV head, on a card: each kernel against its
plain version, bit for bit (tests/test_torch_attn_forms.py holds the plain
versions to the JAX package's kernels on the CPU).  Skipped without a CUDA
device.  No JAX here: the card's machine has none."""

import pytest
import torch

from tmac_tpu_torch.ops.cuda import attention_kernel as ak

# (cache head_dim, head_dim, query heads per KV head, KV heads)
FORMS = [(256, 256, 2, 2), (256, 200, 4, 1), (128, 128, 12, 1), (128, 100, 16, 1),
         (256, 256, 12, 1), (384, 384, 3, 2), (512, 500, 2, 2)]


@pytest.mark.parametrize("Dp,Dl,rep,KV", FORMS)
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_kernels_equal_plain_on_card(quant, Dp, Dl, rep, KV):
    """On a card: K2/K6, K8 and K9 at each form equal their plain versions
    bit for bit (K9's cache too), with and without a window, over 2047
    rows (chip_smoke.py --phase attn_forms runs the full set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev, S_ = torch.device("cuda"), 2048
    gen = torch.Generator(device=dev).manual_seed(Dp + rep)
    q = torch.randn((2, KV, rep, Dl), generator=gen, device=dev).to(torch.bfloat16)
    cur = torch.randn((2, 2, KV, Dl), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((2, 2, 2, KV, S_, Dl), generator=gen, device=dev)
    kv = torch.nn.functional.pad(kv, (0, Dp - Dl))
    if quant:
        codes, sc = ak.quantize_kv(kv)
        cache = dict(k=codes[0], v=codes[1], k_scale=sc[0].contiguous(),
                     v_scale=sc[1].contiguous())
    else:
        cache = dict(k=kv[0].to(torch.bfloat16), v=kv[1].to(torch.bfloat16))
    lens = torch.tensor([2047, S_], dtype=torch.int32, device=dev)
    li = torch.tensor([1], dtype=torch.int32, device=dev)
    for window in (0, 1000):
        kw = dict(window=window, k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        got = ak.flash_decode(q, cache["k"], cache["v"], lens, li, **kw)
        assert torch.equal(got, ak.flash_decode_plain(q, cache["k"], cache["v"], lens, li, **kw))
        got = ak.flash_decode_append(q, cache["k"], cache["v"], lens, li, cur[0], cur[1], **kw)
        assert torch.equal(got, ak.flash_decode_append_plain(q, cache["k"], cache["v"], lens, li,
                                                             cur[0], cur[1], **kw))
        a = {n: t.clone() for n, t in cache.items()}
        b = {n: t.clone() for n, t in cache.items()}
        got = ak.flash_decode_append_write(q, a["k"], a["v"], lens, li, cur[0], cur[1],
                                           window=window, k_scale=a.get("k_scale"),
                                           v_scale=a.get("v_scale"))
        want = ak.flash_decode_append_write_plain(q, b["k"], b["v"], lens, li, cur[0], cur[1],
                                                  window=window, k_scale=b.get("k_scale"),
                                                  v_scale=b.get("v_scale"))
        assert torch.equal(got, want)
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_k9_graph_replays_after_its_counters_grow():
    """On a card: K9 over two rep tiles (rep 12 at Dp 128), captured in a
    CUDA graph at one batch row, replays right after a launch at more (batch
    row, kv head) pairs than its counter buffer holds has made a larger
    one (the old buffer's size of int32 blocks taken and filled meanwhile):
    its output and stored row equal the plain version's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    KV, rep, D, S = 8, 12, 128, 256
    li = torch.tensor([1], dtype=torch.int32, device=dev)

    def inputs(B):
        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        return (r(B, KV, rep, D), r(2, B, KV, S, D), r(2, B, KV, S, D),
                torch.full((B,), S - 8, dtype=torch.int32, device=dev), r(B, KV, D), r(B, KV, D))
    q, k, v, lens, ck, cv = inputs(1)
    k0, v0 = k.clone(), v.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ak.flash_decode_append_write(q, k, v, lens, li, ck, cv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ak.flash_decode_append_write(q, k, v, lens, li, ck, cv)
    n0 = ak._done[q.device][-1].numel()
    big = inputs(n0 // KV + 1)
    ak.flash_decode_append_write(big[0], big[1], big[2], big[3], li, big[4], big[5])
    assert ak._done[q.device][-1].numel() > n0
    hold = [torch.ones(n0, dtype=torch.int32, device=dev) for _ in range(8)]
    k.copy_(k0)
    v.copy_(v0)
    graph.replay()
    kw, vw = k0.clone(), v0.clone()
    want = ak.flash_decode_append_write_plain(q, kw, vw, lens, li, ck, cv)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(k, kw) and torch.equal(v, vw)
    del hold
