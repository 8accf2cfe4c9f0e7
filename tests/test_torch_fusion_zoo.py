"""The fusion zoo: heal_tpu_torch.models.fuse vs heal_tpu.models.fuse on
the CPU.

Every method of ``build_fusion`` (max, att, disconet, v2vnet, where2comm
and its three aggregations, who2com, cobevt, v2xvit, when2com,
transformer) is initialised in flax, bridged into the port
(utils/bridge.py, strict) and run on the same seeded inputs: B 2, L 3
with a padded slot in the first sample, 16 x 32 cells, C 32. On the CPU
both packages take the exact warp. Stated tolerance: max |d| /
(1 + max |ref|) <= 1e-5 (f32 contractions summed in another order).
Also held: ``warp_pairwise`` exact and shear, ``CommMask`` at a fixed
threshold, the positional maps and relative-position indices, V2X-ViT's
invariance to the order of the collaborators, and that nothing a padded
slot holds reaches the output.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models.fuse import cobevt as jcobevt
from heal_tpu.models.fuse import fusion_in_one as jfuse
from heal_tpu.models.fuse import legacy as jlegacy
from heal_tpu.models.fuse import where2comm_comm as jcomm
from heal_tpu.ops import warp as jw
from heal_tpu_torch.models.fuse import build_fusion
from heal_tpu_torch.models.fuse import cobevt as tcobevt
from heal_tpu_torch.models.fuse import fusion_in_one as tfuse
from heal_tpu_torch.models.fuse import legacy as tlegacy
from heal_tpu_torch.models.fuse.where2comm_comm import CommMask
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.ops import warp as tw
from heal_tpu_torch.utils.bridge import load_flax

torch.set_num_threads(1)
B, L, H, W, C = 2, 3, 16, 32, 32
TOL = 1e-5
MASK = np.array([[1, 1, 0], [1, 1, 1]], bool)
TYPES = np.array([[0, 2, 4], [1, 0, 3]], np.int32)  # padded slot: 4

# method -> (args, extra call inputs)
CASES = {
    "max": ({}, ()),
    "att": ({}, ()),
    "disconet": ({"in_channels": 24}, ()),
    "v2vnet": ({"in_channels": C, "num_iteration": 2}, ()),
    "v2vnet_max": ({"in_channels": C, "num_iteration": 1,
                    "agg_operator": "max", "gru_flag": False}, ()),
    "where2comm": ({"in_channels": C, "threshold": 0.5}, ("confidence",)),
    "where2comm_spe": ({"in_channels": C, "threshold": 0.5,
                        "agg_operator": {"mode": "transformer", "n_head": 4,
                                         "with_spe": True}},
                       ("confidence",)),
    "where2comm_atten": ({"in_channels": C, "agg_operator": {
        "mode": "atten"}}, ("confidence",)),
    "where2comm_max": ({"in_channels": C, "agg_operator": {"mode": "max"}},
                       ("comm_mask",)),
    "where2comm_plain": ({"in_channels": C}, ()),
    "who2com": ({"in_channels": 24}, ()),
    "cobevt": ({"window_size": 4, "depth": 1}, ()),
    "cobevt_pad": ({"window_size": 6, "depth": 1}, ()),
    "v2xvit": ({"depth": 1, "num_types": 5}, ("agent_types",)),
    "v2xvit_untyped": ({"transformer": {"encoder": {"depth": 1,
                                                    "num_blocks": 2}},
                        "windows": [2, 4]}, ()),
    "when2com": ({"policy_width": 16, "key_size": 24, "query_size": 8}, ()),
    "when2com_activated": ({"policy_width": 16, "mode": "activated",
                            "threshold": 0.3}, ()),
    "transformer": ({"n_head": 4}, ()),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _M(theta, tx, ty, h=H, w=W):
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s * h / w, tx], [s * w / h, c, ty]], np.float32)


def _affine(seed, b=B, l=L):
    """(B, L, L, 2, 3) rigid normalized affines from random 2D poses: the
    diagonal is the identity."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(-np.pi, np.pi, (b, l))
    t = rng.uniform(-0.4, 0.4, (b, l, 2))
    aff = np.zeros((b, l, l, 2, 3), np.float32)
    for bi in range(b):
        for i in range(l):
            for j in range(l):
                d = t[bi, j] - t[bi, i]
                aff[bi, i, j] = _M(theta[bi, j] - theta[bi, i], *d) \
                    if i != j else _M(0.0, 0.0, 0.0)
    return aff


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, H, W, C).astype(np.float32)
    conf = rng.uniform(0, 1, (B, L, H, W, 1)).astype(np.float32)
    comm = (rng.uniform(0, 1, (B, L, H, W, 1)) > 0.4).astype(np.float32)
    return {"x": x, "aff": _affine(seed + 1), "mask": MASK,
            "confidence": conf, "comm_mask": comm, "agent_types": TYPES}


def _random_stats(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key == "var"
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        jax.device_get(tree))


def _pair(case, seed=0):
    """(JAX's eval output, the bridged port module): one jitted
    init_with_output, and an apply for the modules whose running
    statistics are then randomised."""
    method = case.split("_")[0]
    args, _ = CASES[case]
    inp = _inputs(seed)
    jm = jfuse.build_fusion(method, dict(args))
    kw = _extra(case, inp, jnp.asarray)
    args_j = (jnp.asarray(inp["x"]), jnp.asarray(inp["aff"]),
              jnp.asarray(inp["mask"]))
    want, v = jax.device_get(jax.jit(lambda *a, **k: jm.init_with_output(
        jax.random.PRNGKey(seed), *a, False, **k))(*args_j, **kw))
    if "batch_stats" in v:
        v = dict(v, batch_stats=_random_stats(v["batch_stats"], seed))
        want = None  # the output of the randomised statistics: _run_jax
    tm = build_fusion(method, dict(args), C, max_cav=L)
    load_flax(tm, v.get("params", {}), v.get("batch_stats", {}))
    return (jm, v, want), tm.eval()


def _port(case, seed=0):
    """The port module of ``case`` from its own seeded init."""
    method = case.split("_")[0]
    tm = build_fusion(method, dict(CASES[case][0]), C, max_cav=L)
    return init_weights(tm, torch.Generator().manual_seed(seed)).eval()


def _extra(case, inp, conv):
    return {k: conv(inp[k]) for k in CASES[case][1]}


def _run_jax(ref, inp, case, train=False):
    jm, v, want = ref
    if want is not None and not train:
        return want
    kw = _extra(case, inp, jnp.asarray)
    args = (jnp.asarray(inp["x"]), jnp.asarray(inp["aff"]),
            jnp.asarray(inp["mask"]))

    def run(variables, *a, **k):
        if train and "batch_stats" in variables:
            return jm.apply(variables, *a, True, mutable=["batch_stats"],
                            **k)[0]
        return jm.apply(variables, *a, train, **k)

    return jax.device_get(jax.jit(run)(v, *args, **kw))


def _run_port(tm, inp, case):
    kw = _extra(case, inp, torch.from_numpy)
    with torch.no_grad():
        return tm(torch.from_numpy(inp["x"]), torch.from_numpy(inp["aff"]),
                  torch.from_numpy(inp["mask"]), **kw)


def _check(got, want):
    if isinstance(want, tuple):  # where2comm with a confidence: comm rate
        assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-7)
        got, want = got[0], want[0]
    assert tuple(got.shape) == want.shape
    assert np.abs(want).max() > 0
    assert _rel(got.numpy(), want) <= TOL, _rel(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fusion_matches_jax_eval(case):
    ref, tm = _pair(case)
    _check(_run_port(tm, _inputs(), case), _run_jax(ref, _inputs(), case))


@pytest.mark.parametrize("case", ["disconet", "when2com", "where2comm",
                                  "v2vnet"])
def test_fusion_matches_jax_train_mode(case):
    """Train mode: batch statistics in the batch-norm fusions; where2comm
    without a ``comm`` stream keeps its fixed threshold, as JAX without a
    ``comm`` rng."""
    ref, tm = _pair(case, seed=1)
    inp = _inputs(1)
    tm.train()
    _check(_run_port(tm, inp, case), _run_jax(ref, inp, case, train=True))


@pytest.mark.parametrize("case", ["max", "att", "disconet", "v2vnet",
                                  "where2comm", "who2com", "cobevt",
                                  "v2xvit", "when2com", "transformer"])
def test_padded_slot_cannot_change_the_output(case):
    tm = _port(case, seed=2)
    inp = _inputs(2)
    base = _run_port(tm, inp, case)
    noisy = dict(inp, x=inp["x"].copy(), aff=inp["aff"].copy(),
                 confidence=inp["confidence"].copy())
    noisy["x"][0, 2] = 1e3 * np.random.RandomState(9).randn(H, W, C)
    noisy["confidence"][0, 2] = 1.0
    noisy["aff"][0, :, 2] = _M(1.1, 0.05, -0.02)
    got = _run_port(tm, noisy, case)
    if isinstance(base, tuple):
        base, got = base[0], got[0]
    assert _rel(got[0].numpy(), base[0].numpy()) <= TOL
    torch.testing.assert_close(got[1], base[1], rtol=0, atol=0)


def test_v2xvit_is_invariant_to_the_order_of_collaborators():
    """Swapping the two non-ego agents (their features, poses, types and
    masks) leaves the ego's fused map as it was: the embeddings follow the
    agent type, not the slot."""
    tm = _port("v2xvit", seed=3)
    inp = _inputs(3)
    perm = [0, 2, 1]
    swapped = dict(inp, x=inp["x"][:, perm], aff=inp["aff"][:, perm][:, :,
                                                                    perm],
                   mask=inp["mask"][:, perm], agent_types=TYPES[:, perm])
    assert _rel(_run_port(tm, swapped, "v2xvit").numpy(),
                _run_port(tm, inp, "v2xvit").numpy()) <= TOL


@pytest.mark.parametrize("method", ["exact", "shear"])
def test_warp_pairwise_matches_jax(method):
    rng = np.random.RandomState(4)
    x = rng.randn(B, L, H, W, 5).astype(np.float32)
    aff = _affine(5)
    got = tw.warp_pairwise(torch.from_numpy(x), torch.from_numpy(aff),
                           method=method).numpy()
    want = np.asarray(jax.jit(jw.warp_pairwise, static_argnames="method")(
        jnp.asarray(x), jnp.asarray(aff), method=method))
    assert got.shape == (B, L, L, H, W, 5)
    assert _rel(got, want) <= 2e-5  # tests/test_torch_warp.py's WARP_TOL
    # the diagonal is the identity warp (the exact one samples at
    # positions an f32 rounding off the centres); "auto" is exact on the CPU
    np.testing.assert_allclose(got[:, 1, 1], x[:, 1], atol=1e-5)
    if method == "exact":
        auto = tw.warp_pairwise(torch.from_numpy(x), torch.from_numpy(aff))
        np.testing.assert_array_equal(auto.numpy(), got)


@pytest.mark.parametrize("smooth", [True, False])
def test_comm_mask_matches_jax_at_a_fixed_threshold(smooth):
    rng = np.random.RandomState(6)
    conf = rng.uniform(0, 1, (B, L, H, W, 1)).astype(np.float32) ** 3
    kw = dict(threshold=0.2, gaussian_smooth=smooth, smooth_sigma=1.3)
    jm = jcomm.CommMask(**kw)
    want_mask, want_rate = jm.apply({}, jnp.asarray(conf), True)
    port = CommMask(**kw).train()
    mask, rate = port(torch.from_numpy(conf))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert float(rate) == pytest.approx(float(want_rate), abs=1e-7)
    assert 0 < float(rate) < 1
    gated = tfuse.apply_comm_mask(torch.ones(B, L, 2, 2, 1),
                                  torch.zeros(B, L, 2, 2, 1))
    assert gated[:, 0].eq(1).all() and gated[:, 1:].eq(0).all()


def test_positional_maps_and_relative_position_indices_match_jax():
    np.testing.assert_allclose(
        tfuse.sinusoidal_pe(H, W, C).numpy(),
        np.asarray(jfuse.sinusoidal_pe(H, W, C)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlegacy.sine_pe_2d(H, W, 24).numpy(),
        np.asarray(jlegacy.sine_pe_2d(H, W, 24)), rtol=1e-6, atol=1e-6)
    # CoBEVT's (agent, dy, dx) bias over the window tokens
    class Bias(jcobevt.SwapAttention):
        @flax.linen.compact
        def __call__(self, l):
            return self._rel_pos_bias(l)

    sa = Bias(C, 4)
    v = sa.init(jax.random.PRNGKey(0), L)
    want = np.asarray(sa.apply(v, L))
    port = tcobevt.SwapAttention(C, 4, L)
    port.rel_pos_bias.data = torch.from_numpy(
        np.asarray(v["params"]["rel_pos_bias"]))
    np.testing.assert_array_equal(port._bias(L).detach().numpy(), want)
    idx = tcobevt.rel_pos_index(L, 4)
    assert idx.shape == (L * 16, L * 16) and idx.min() == 0
    assert idx.max() == (2 * L - 1) * 49 - 1


@pytest.mark.parametrize("bias_batch", [1, 6])
def test_chunked_biased_attention_matches_plain_autograd(monkeypatch,
                                                         bias_batch):
    """The window attentions' chunked attention (no probabilities kept
    for the backward) against autograd through the plain softmax, forward
    and every gradient, with chunks of 2 windows."""
    from heal_tpu_torch.models import layers

    monkeypatch.setattr(layers, "_ATTN_CHUNK_BYTES", 2 * 4 * 7 * 7 * 4)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((6, 7, 4, 3), generator=g, requires_grad=True)
               for _ in range(3))
    bias = torch.randn((bias_batch, 4, 7, 7), generator=g,
                       requires_grad=True)
    cot = torch.randn((6, 7, 4, 3), generator=g)

    def plain():
        logits = torch.einsum("nqhd,nkhd->nhqk", q / 3 ** 0.5, k) + bias
        return torch.einsum("nhqk,nkhd->nqhd", torch.softmax(logits, -1), v)

    outs = []
    for fn in (lambda: layers.dot_product_attention(q, k, v, bias=bias),
               plain):
        out = fn()
        grads = torch.autograd.grad((out * cot).sum(), (q, k, v, bias))
        outs.append((out.detach(), grads))
    (got, got_g), (want, want_g) = outs
    assert _rel(got, want) <= TOL
    for a, b in zip(got_g, want_g):
        assert _rel(a, b) <= TOL
