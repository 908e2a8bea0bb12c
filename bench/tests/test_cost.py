"""The FLOP and byte functions against hand-computed cases."""
from bench.cost import convex, lm
from bench.data import lm_weights
from bench.harness import cells

TINY = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 2, "intermediate_size": 8, "vocab_size": 10,
        "num_hidden_layers": 1}


def test_matmul_params_and_step_flops():
    # wq 4*4, wk and wv 4*2 each, wo 4*4, the MLP 3*4*8, the head 4*10
    assert lm.matmul_params(TINY) == 16 + 16 + 16 + 96 + 40
    assert lm.pairs(4) == 10
    traffic = {"seq": 4, "microbatch": 1, "accum": 2}
    # 6 * 184 weights * 8 tokens, plus 12 * 10 pairs * 2 heads * hd 2 * 2 rows
    assert lm.step_flops(TINY, traffic) == 6 * 184 * 8 + 12 * 10 * 2 * 2 * 2


def test_kernel_work():
    assert lm.k1_bytes(10, 1) == 280
    assert lm.k1_bytes(10, 3) == 840
    # 4 * 10 pairs * hd 2 * 2 heads; bf16 q, k, v and out of 4 positions
    assert lm.flash_fwd(4, 2, 1, 2, 1) == (160, 2 * 4 * 2 * (4 + 2))
    # per step a row of 5 doubles, index, label, entry read and written;
    # per worker x in and out, gbar, the accumulator
    assert convex.vr_epoch_bytes(2, 3, 5) == 2 * 3 * (40 + 32) + 4 * 2 * 5 * 8
    assert convex.samples_per_solve(2, 3, 4) == 30


def test_qwen2_cell_sizes():
    conf = cells.load_json(cells.BENCH / "configs" / "qwen2-7b-l4.json")
    layer = 3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944
    assert lm.matmul_params(conf) == 4 * layer + 3584 * 152064
    # every weight: the matrices, the embedding, q/k/v biases, norms
    _, n = lm_weights.offsets(conf)
    assert n == (lm.matmul_params(conf) + 152064 * 3584
                 + 4 * (3584 + 2 * 512) + 4 * 2 * 3584 + 3584)
    assert n == 2_022_229_504
