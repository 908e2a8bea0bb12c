"""The plain references against hand-computed cases."""
import math

import torch

from bench.reference import convex_sync, lm_dense


def test_rmsnorm_and_rope():
    x = torch.tensor([[3.0, 4.0]])
    y = lm_dense.rmsnorm(x, torch.ones(2), 0.0)
    r = math.sqrt(12.5)
    assert torch.allclose(y, torch.tensor([[3 / r, 4 / r]]))
    q = torch.randn(1, 5, 3, 8)
    out = lm_dense.rope(q, 10_000.0)
    assert torch.equal(out[:, 0], q[:, 0])           # position 0: no turn
    half = torch.stack([q[..., :4], q[..., 4:]], -1).norm(dim=-1)
    half_out = torch.stack([out[..., :4], out[..., 4:]], -1).norm(dim=-1)
    assert torch.allclose(half, half_out, atol=1e-5)  # a rotation per pair


def test_attention_is_causal_softmax():
    torch.manual_seed(0)
    q, k, v = torch.randn(1, 6, 4, 8), torch.randn(1, 6, 2, 8), \
        torch.randn(1, 6, 2, 8)
    out = lm_dense.attention(q, k, v).view(1, 6, 4, 8)
    for h in range(4):
        kh, vh = k[0, :, h // 2], v[0, :, h // 2]
        s = q[0, :, h] @ kh.T / math.sqrt(8)
        s = s.masked_fill(torch.triu(torch.ones(6, 6, dtype=torch.bool), 1),
                          float("-inf"))
        assert torch.allclose(out[0, :, h], torch.softmax(s, -1) @ vh,
                              atol=1e-5)


def _tiny():
    conf = {"hidden_size": 8, "intermediate_size": 16,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "num_hidden_layers": 1, "vocab_size": 11, "rms_norm_eps": 1e-6,
            "rope_theta": 10_000.0, "initializer_range": 0.5}
    from bench.data import lm_weights
    return conf, lm_weights


def test_uniform_head_gives_log_vocab():
    conf, lm_weights = _tiny()
    flat = lm_weights.make(conf, 3, "cpu")
    w = lm_weights.views(flat, conf)
    w["head"].zero_()
    tokens = torch.randint(0, 11, (2, 5))
    assert torch.allclose(lm_dense.loss(w, conf, tokens),
                          torch.tensor(math.log(11.0)))


def test_centralvr_steps_follow_the_update_rule():
    """Three steps with M = 2: x1 = x0 - lr g0, x2 = x1 - lr g1, then
    x3 = x2 - lr (g2 - g0 + (g0 + g1) / 2), each g the gradient at the
    iterate of its step."""
    conf, lm_weights = _tiny()
    train = {"vr_table_size": 2, "learning_rate": 0.1}
    tokens = torch.randint(0, 11, (1, 2, 1, 1, 6))

    def grad(flat, k):
        p = flat.clone().requires_grad_()
        lo = lm_dense.loss(lm_weights.views(p, conf), conf, tokens[0, k, 0])
        return torch.autograd.grad(lo, p)[0]

    x0 = lm_weights.make(conf, 5, "cpu")
    g0 = grad(x0, 0)
    x1 = x0 - 0.1 * g0
    g1 = grad(x1, 1)
    x2 = x1 - 0.1 * g1
    g2 = grad(x2, 0)
    x3 = x2 - 0.1 * (g2 - g0 + 0.5 * (g0 + g1))
    flat = x0.clone()
    out = lm_dense.train(conf, train, flat, lm_weights.views(flat, conf),
                         tokens, 3)
    assert torch.allclose(out["x"], x3, atol=1e-6)
    assert abs(out["grad0"]["head"]
               - float(lm_weights.views(g0, conf)["head"].norm())) < 1e-6


def test_convex_sync_by_hand():
    """p = 1, two rows of one feature, one round, worked out by hand."""
    A = torch.tensor([[[1.0], [2.0]]], dtype=torch.float64)
    b = torch.tensor([[1.0, -1.0]], dtype=torch.float64)
    lam = 0.01
    init = torch.tensor([[[1, 0]]])
    rounds = torch.tensor([[[[0, 1]]]])
    eta = 0.3 / (0.25 * 4.0 + 2 * lam)
    sig = lambda z: 1.0 / (1.0 + math.exp(-z))  # noqa: E731
    res = lambda z, y: -y * sig(-y * z)          # noqa: E731
    a, y = [1.0, 2.0], [1.0, -1.0]
    x, table, acc = 0.0, [0.0, 0.0], 0.0
    for j in (1, 0):                              # the SGD epoch
        s = res(a[j] * x, y[j])
        table[j] = s
        acc += s * a[j] / 2
        x -= eta * (s * a[j] + 2 * lam * x)
    gbar = acc
    acc = 0.0
    for j in (0, 1):                              # one round
        s = res(a[j] * x, y[j])
        v = (s - table[j]) * a[j] + gbar + 2 * lam * x
        table[j] = s
        acc += s * a[j] / 2
        x -= eta * v

    def fgrad(x):
        return sum(res(a[j] * x, y[j]) * a[j] for j in (0, 1)) / 2 \
            + 2 * lam * x
    xr, rels = convex_sync.solve(A, b, lam, init, rounds)
    assert abs(float(xr[0, 0]) - x) < 1e-14
    assert abs(float(rels[0, 0]) - abs(fgrad(x)) / abs(fgrad(0.0))) < 1e-13
