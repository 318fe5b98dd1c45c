"""Weights, inputs and frozen results of the reference LM, for holding
the port against JAX where JAX cannot run (the card).

:func:`jax_layout_params` makes a dense GQA model's weights with numpy
from a seed, in the reference's pytree layout (``params["blocks"]`` a
tuple over pattern positions, each stacked along a leading repeat axis),
so the same arrays feed ``repro.models.transformer`` and, through
:func:`repro_torch.models.transformer.params_from_jax`, the port.
``LM_ANCHORS`` holds what the JAX reference computed from them on the
CPU for the reduced float32 gemma2-2b and qwen2-0.5b: full-forward
logits at fixed positions and greedy tokens after a prefill
(``tests/test_torch_transformer.py`` recomputes them with JAX).
"""

from __future__ import annotations

import numpy as np

from .common import ModelConfig

#: Inputs of the anchors: forward batch and length, the prompt of the
#: greedy run and its number of generated tokens, the seeds.
FORWARD_SHAPE = (2, 256)
PROMPT_SHAPE = (2, 8)
GREEDY_STEPS = 8
WEIGHT_SEED, TOKEN_SEED = 11, 12
#: (batch, position) of each logits row frozen, and how many leading
#: vocabulary entries of it.
ANCHOR_ROWS = ((0, 0), (0, 63), (0, 64), (1, 200), (1, 255))
ANCHOR_VOCAB = 16


def jax_layout_params(cfg: ModelConfig, seed: int = WEIGHT_SEED) -> dict:
    """float32 weights of a dense GQA ``cfg`` in the reference's layout:
    normals at the reference's fan-in scales, and (unlike its init) norm
    scales and biases drawn at 0.1, so that they are exercised."""
    rng = np.random.default_rng(seed)
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, r = cfg.resolved_head_dim, cfg.num_pattern_repeats

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    params = {"embed": {"table": normal((cfg.vocab_size, d), d ** -0.5)},
              "final_norm": {"scale": normal((d,), 0.1)}}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": normal((d, cfg.vocab_size), d ** -0.5)}
    blocks = []
    for _ in cfg.block_pattern:
        mixer = {"w_q": normal((r, d, h, hd), d ** -0.5),
                 "w_k": normal((r, d, kvh, hd), d ** -0.5),
                 "w_v": normal((r, d, kvh, hd), d ** -0.5),
                 "w_o": normal((r, h, hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            mixer.update(b_q=normal((r, h, hd), 0.1),
                         b_k=normal((r, kvh, hd), 0.1),
                         b_v=normal((r, kvh, hd), 0.1))
        p = {"norm1": {"scale": normal((r, d), 0.1)}, "mixer": mixer}
        if cfg.d_ff:
            ffn = {"w_up": normal((r, d, cfg.d_ff), d ** -0.5),
                   "w_down": normal((r, cfg.d_ff, d), cfg.d_ff ** -0.5)}
            if cfg.ffn_kind == "swiglu":
                ffn["w_gate"] = normal((r, d, cfg.d_ff), d ** -0.5)
            p.update(norm2={"scale": normal((r, d), 0.1)}, ffn=ffn)
        if cfg.post_block_norm:
            p["post_norm1"] = {"scale": normal((r, d), 0.1)}
            if cfg.d_ff:
                p["post_norm2"] = {"scale": normal((r, d), 0.1)}
        blocks.append(p)
    params["blocks"] = tuple(blocks)
    return params


def anchor_tokens(cfg: ModelConfig, seed: int = TOKEN_SEED) -> tuple:
    """(forward tokens (2, 256), prompt tokens (2, 8)), int32."""
    rng = np.random.default_rng(seed)
    fwd = rng.integers(0, cfg.vocab_size, FORWARD_SHAPE).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, PROMPT_SHAPE).astype(np.int32)
    return fwd, prompt


#: Frozen JAX results (JAX 0.9 on the CPU), by arch id, for the reduced
#: config in float32: ``logits`` the first ANCHOR_VOCAB logits of each
#: ANCHOR_ROWS row of the forward, ``row_sums`` each such row summed over
#: the vocabulary (float64), ``greedy`` the GREEDY_STEPS tokens after the
#: prompt, ``min_top2_gap`` the smallest top-1/top-2 logit gap over the
#: greedy steps (how far the tokens are from a tie).
LM_ANCHORS: dict = {
    "gemma2-2b": {
        "logits": (
            (
                0.4238858222961426, -0.9387128353118896, -1.2618604898452759,
                0.5094147324562073, -0.7506167888641357, 0.8821092247962952,
                -0.8551749587059021, -0.6817008852958679, 0.06993626058101654,
                -1.70863938331604, -0.978277862071991, 0.6824630498886108,
                0.6204118132591248, -0.08077745139598846, -1.2241641283035278,
                0.9259642362594604,
            ),
            (
                -0.010979444719851017, -0.7495918869972229, 0.6730014085769653,
                -1.5814772844314575, -0.22215399146080017, -0.9877561330795288,
                -0.07912282645702362, 0.13359738886356354, 0.7930679321289062,
                -1.1672695875167847, -0.35592979192733765, -0.5106886029243469,
                -0.6515172123908997, 0.522499680519104, -0.7347602844238281,
                0.4216853380203247,
            ),
            (
                0.9462952017784119, -2.359127998352051, -0.8048762679100037,
                -0.5027996301651001, 0.05263520032167435, -0.8665638566017151,
                1.8065123558044434, 1.792723536491394, -0.04491479694843292,
                -1.463767409324646, -1.0820311307907104, -0.826332688331604,
                0.18593500554561615, -0.10385775566101074, -0.5096196532249451,
                0.4302188754081726,
            ),
            (
                0.03720291331410408, -1.9239094257354736, -0.2452557384967804,
                -2.071467876434326, -1.1512603759765625, 0.6348927021026611,
                -1.7104822397232056, 0.5541588664054871, -0.82960045337677,
                -0.4996779263019562, 0.9123347401618958, 0.9430767297744751,
                1.149705171585083, 0.5502553582191467, -0.6895235776901245,
                1.3112881183624268,
            ),
            (
                -0.8812562227249146, -0.49646666646003723, -0.1925412118434906,
                0.2690389156341553, -0.23330438137054443, -0.4056686460971832,
                -1.8238552808761597, 0.20230497419834137, -1.7105438709259033,
                -0.33107760548591614, -0.5626073479652405, 1.470381736755371,
                1.465545415878296, 1.7774667739868164, 0.6222512125968933,
                -0.3555699586868286,
            ),
        ),
        "row_sums": (
            -30.71242032852024, -51.282655119663104, -18.436377598380204,
            -11.830961761530489, 9.229475648433436,
        ),
        "greedy": (
            (146, 146, 146, 146, 146, 146, 146, 146),
            (211, 211, 211, 211, 211, 211, 211, 211),
        ),
        "min_top2_gap": 0.05688619613647461,
    },
    "qwen2-0.5b": {
        "logits": (
            (
                1.1576638221740723, 0.8566122055053711, -0.5385152101516724,
                0.6257202625274658, 0.04399098828434944, -0.3862529397010803,
                -1.3941916227340698, -1.0262038707733154, 0.46828341484069824,
                -1.3020975589752197, 0.5802278518676758, -0.3909369111061096,
                -1.3620325326919556, -0.9639796018600464, -0.33121010661125183,
                -1.803122878074646,
            ),
            (
                1.3012837171554565, -0.6159036159515381, -1.0614013671875,
                -0.32780471444129944, 0.22446686029434204, -2.0840373039245605,
                -0.40753173828125, 0.29541894793510437, -1.371417760848999,
                -2.0751123428344727, 2.2331652641296387, -0.6968017220497131,
                -0.2973354160785675, -0.5634353756904602, 2.125509262084961,
                -1.2904162406921387,
            ),
            (
                0.3391122817993164, -0.5820411443710327, -1.492592215538025,
                0.45354723930358887, 0.8333090543746948, 0.4640316069126129,
                0.8990844488143921, -1.2236320972442627, -0.13918256759643555,
                -1.430165410041809, 1.8589661121368408, -1.2995461225509644,
                -0.9062111377716064, -1.8192681074142456, -0.10833582282066345,
                -1.8357051610946655,
            ),
            (
                -0.47472357749938965, -0.6743641495704651, -0.14461007714271545,
                0.4417860209941864, 0.0936570018529892, 0.636074960231781,
                1.8701138496398926, 1.2615693807601929, 0.9281687140464783,
                -0.29640379548072815, 1.251713752746582, 0.06438170373439789,
                1.100874423980713, 1.169427514076233, 0.02513289824128151,
                -0.5632333755493164,
            ),
            (
                -0.16316097974777222, 0.6104708909988403, 0.018096674233675003,
                0.4769009053707123, 0.7016685605049133, 0.2496551126241684,
                0.2735222578048706, 0.4432718753814697, 1.2015126943588257,
                -1.356536865234375, 0.7118019461631775, -0.6872309446334839,
                -1.1982436180114746, 0.12405750900506973, -1.410215973854065,
                -0.20559652149677277,
            ),
        ),
        "row_sums": (
            6.466861121240072, -46.144480016082525, -45.41502603303525,
            74.1265019304119, 17.95120790391229,
        ),
        "greedy": (
            (98, 98, 98, 98, 98, 98, 98, 79),
            (223, 284, 340, 337, 337, 337, 337, 344),
        ),
        "min_top2_gap": 0.05159473419189453,
    },
}
