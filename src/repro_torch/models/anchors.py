"""Weights, inputs and frozen results of the reference LM, for holding
the port against JAX where JAX cannot run (the card).

:func:`jax_layout_params` makes a model's weights (GQA, Mamba, mLSTM
and sLSTM blocks, dense or MoE FFNs, a dense prologue) with numpy from
a seed, in the reference's
pytree layout (``params["blocks"]`` a tuple over pattern positions, each
stacked along a leading repeat axis; the prologue's ``pre_{i}``
unstacked), so the same arrays feed ``repro.models.transformer`` and,
through :func:`repro_torch.models.transformer.params_from_jax`, the
port.  ``LM_ANCHORS`` holds what the JAX reference computed from them on
the CPU for the reduced float32 gemma2-2b, qwen2-0.5b, arctic-480b,
xlstm-350m, jamba-v0.1-52b, deepseek-v2-236b, qwen2-vl-2b and
musicgen-large: full-forward logits at fixed positions (the
modality-stub archs' on :func:`anchor_embeds`, qwen2-vl's at
:func:`image_positions`) and greedy tokens after a prefill, and for the
MoE archs the forward's routes (``tests/test_torch_transformer.py`` and,
for the SSM archs, ``tests/test_torch_ssm_models.py``, for deepseek-v2
``tests/test_torch_mla_models.py``, for the stub archs
``tests/test_torch_stub_models.py`` recompute them with JAX);
:func:`record_routes` and :func:`routes_digest` read and condense the
port's routes.  ``TRAIN_ANCHORS`` holds the reference's training run
from the same weights: each step's loss and global gradient norm, and
the first step's gradient norm of every leaf
(``tests/test_torch_train.py`` recomputes them with JAX);
:func:`train_run` is the port's run of it.
"""

from __future__ import annotations

import contextlib
import math
import zlib

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
    """float32 weights of ``cfg`` (GQA, MLA, Mamba, mLSTM and sLSTM
    blocks; dense or MoE FFNs; a dense prologue) in the reference's
    layout: matrices as normals at the reference's fan-in scales, and
    (unlike its init) norm scales (MLA's ``q_norm`` and ``kv_norm``
    among them) and GQA biases drawn at 0.1, and every other
    leaf of an SSM block as the reference's init value plus a
    0.1-scaled normal (``A_log`` = log(1..N), ``dt_bias`` = log(e - 1),
    ``D`` = 1, ``b_fg`` = 3, the sLSTM ``b_f`` = 1, the rest 0), so that
    each is exercised while the model stays in the reference's regime.
    The prologue's ``pre_{i}`` blocks are unstacked; an MoE block's
    ``ffn`` holds the router (d, E) float32, ``w_gate``/``w_up`` (E, d,
    f), ``w_down`` (E, f, d) and the ``shared``/``residual`` dense FFNs
    its config asks for.  The draws of GQA stacks are those of the
    anchors frozen before SSM blocks came."""
    from .transformer import _pattern_moe_flags

    rng = np.random.default_rng(seed)
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def near(shape, value):
        """The reference's init ``value`` plus a 0.1-scaled normal."""
        return (value + rng.standard_normal(shape) * 0.1).astype(np.float32)

    def dense_ffn(lead, f):
        ffn = {"w_up": normal(lead + (d, f), d ** -0.5),
               "w_down": normal(lead + (f, d), f ** -0.5)}
        if cfg.ffn_kind == "swiglu":
            ffn["w_gate"] = normal(lead + (d, f), d ** -0.5)
        return ffn

    def moe(lead):
        m = cfg.moe
        e, f = m.num_experts, m.d_ff_expert
        ffn = {"router": normal(lead + (d, e), d ** -0.5),
               "w_gate": normal(lead + (e, d, f), d ** -0.5),
               "w_up": normal(lead + (e, d, f), d ** -0.5),
               "w_down": normal(lead + (e, f, d), f ** -0.5)}
        if m.num_shared_experts:
            ffn["shared"] = dense_ffn(lead, f * m.num_shared_experts)
        if m.dense_residual:
            ffn["residual"] = dense_ffn(lead, cfg.d_ff)
        return ffn

    def gqa(lead):
        mixer = {"w_q": normal(lead + (d, h, hd), d ** -0.5),
                 "w_k": normal(lead + (d, kvh, hd), d ** -0.5),
                 "w_v": normal(lead + (d, kvh, hd), d ** -0.5),
                 "w_o": normal(lead + (h, hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            mixer.update(b_q=normal(lead + (h, hd), 0.1),
                         b_k=normal(lead + (kvh, hd), 0.1),
                         b_v=normal(lead + (kvh, hd), 0.1))
        return mixer

    def mla(lead):
        """MLA's leaves in the reference's ``mla_init`` layout: the q LoRA
        (``w_dq``, ``q_norm``, ``w_uq``) or ``w_q``, then ``w_dkv``,
        ``kv_norm``, ``w_kr``, ``w_uk``, ``w_uv``, ``w_o``."""
        nope, rope, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
        vd, ql = cfg.v_head_dim, cfg.q_lora_rank
        mixer = {}
        if ql:
            mixer.update(w_dq=normal(lead + (d, ql), d ** -0.5),
                         q_norm={"scale": near(lead + (ql,), 0.0)},
                         w_uq=normal(lead + (ql, h, nope + rope), ql ** -0.5))
        else:
            mixer["w_q"] = normal(lead + (d, h, nope + rope), d ** -0.5)
        mixer.update(w_dkv=normal(lead + (d, r), d ** -0.5),
                     kv_norm={"scale": near(lead + (r,), 0.0)},
                     w_kr=normal(lead + (d, rope), d ** -0.5),
                     w_uk=normal(lead + (r, h, nope), r ** -0.5),
                     w_uv=normal(lead + (r, h, vd), r ** -0.5),
                     w_o=normal(lead + (h, vd, d), (h * vd) ** -0.5))
        return mixer

    def mamba(lead):
        di, n, w = cfg.ssm_expand * d, cfg.ssm_state_dim, cfg.ssm_conv_width
        r = max(1, d // 16)
        return {"in_proj": normal(lead + (d, 2 * di), d ** -0.5),
                "conv_w": normal(lead + (w, di), w ** -0.5),
                "conv_b": near(lead + (di,), 0.0),
                "w_bcdt": normal(lead + (di, 2 * n + r), di ** -0.5),
                "dt_proj": normal(lead + (r, di), r ** -0.5),
                "dt_bias": near(lead + (di,), math.log(math.e - 1)),
                "A_log": near(lead + (di, n),
                              np.log(np.arange(1, n + 1, dtype=np.float64))),
                "D": near(lead + (di,), 1.0),
                "out_proj": normal(lead + (di, d), di ** -0.5)}

    def mlstm(lead):
        di = 2 * d
        return {"w_up": normal(lead + (d, 2 * di), d ** -0.5),
                "w_q": normal(lead + (di, di), di ** -0.5),
                "w_k": normal(lead + (di, di), di ** -0.5),
                "w_v": normal(lead + (di, di), di ** -0.5),
                "w_ig": normal(lead + (di, h), di ** -0.5),
                "b_ig": near(lead + (h,), 0.0),
                "w_fg": normal(lead + (di, h), di ** -0.5),
                "b_fg": near(lead + (h,), 3.0),
                "w_down": normal(lead + (di, d), di ** -0.5)}

    def slstm(lead):
        p = {}
        for g in ("z", "i", "f", "o"):
            p[f"w_{g}"] = normal(lead + (d, d), d ** -0.5)
            p[f"r_{g}"] = normal(lead + (h, d // h, d // h), (d // h) ** -0.5)
            p[f"b_{g}"] = near(lead + (d,), 1.0 if g == "f" else 0.0)
        p["w_out"] = normal(lead + (d, d), d ** -0.5)
        return p

    mixers = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}

    def block(lead, kind, use_moe):
        """One block's leaves, each with ``lead`` ((R,) stacked, () not)
        in front."""
        if kind.startswith("attn"):
            mixer = mla(lead) if cfg.attention_kind == "mla" else gqa(lead)
        else:
            mixer = mixers[kind](lead)
        p = {"norm1": {"scale": normal(lead + (d,), 0.1)}, "mixer": mixer}
        has_ffn = use_moe or (cfg.d_ff > 0
                              and kind not in ("mlstm", "slstm"))
        if has_ffn:
            ffn = moe(lead) if use_moe else dense_ffn(lead, cfg.d_ff)
            p.update(norm2={"scale": normal(lead + (d,), 0.1)}, ffn=ffn)
        if cfg.post_block_norm:
            p["post_norm1"] = {"scale": normal(lead + (d,), 0.1)}
            if has_ffn:
                p["post_norm2"] = {"scale": normal(lead + (d,), 0.1)}
        return p

    params = {"embed": {"table": normal((cfg.vocab_size, d), d ** -0.5)},
              "final_norm": {"scale": normal((d,), 0.1)}}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": normal((d, cfg.vocab_size), d ** -0.5)}
    lead = (cfg.num_pattern_repeats,)
    params["blocks"] = tuple(
        block(lead, kind, use_moe)
        for kind, use_moe in zip(cfg.block_pattern, _pattern_moe_flags(cfg)))
    for i in range(cfg.first_k_dense):
        params[f"pre_{i}"] = block((), cfg.layer_kind(i), False)
    return params


def anchor_tokens(cfg: ModelConfig, seed: int = TOKEN_SEED) -> tuple:
    """(forward tokens (2, 256), prompt tokens (2, 8)), int32."""
    rng = np.random.default_rng(seed)
    fwd = rng.integers(0, cfg.vocab_size, FORWARD_SHAPE).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, PROMPT_SHAPE).astype(np.int32)
    return fwd, prompt


#: The anchors' modality-stub inputs: the seed of the frontend
#: embeddings, and the M-RoPE prompt's layout (text tokens, image rows and
#: columns of merged patches, text tokens) filling FORWARD_SHAPE's 256.
EMBED_SEED = 13
ANCHOR_IMAGE = (16, 12, 12, 96)


def image_positions(before: int, rows: int, cols: int,
                    after: int) -> np.ndarray:
    """(3, S) int32 t/h/w positions of a prompt of ``before`` text
    tokens, one image of ``rows`` x ``cols`` merged patches and ``after``
    text tokens, by Qwen2-VL's rule: text at t = h = w = its index; the
    image at t = its first index, h and w that plus its row and column;
    the text after it from the largest position so far plus one."""
    text = np.arange(before)
    r, c = np.divmod(np.arange(rows * cols), cols)
    start = before + max(rows, cols)
    tail = start + np.arange(after)
    streams = [np.concatenate([text, before + img, tail])
               for img in (np.zeros_like(r), r, c)]
    return np.stack(streams).astype(np.int32)


def anchor_embeds(cfg: ModelConfig, seed: int = EMBED_SEED) -> tuple:
    """A modality-stub arch's forward inputs: (embeds (2, 256, d)
    float32, seeded normals at the embedding table's scale d^-0.5, and
    for M-RoPE the (3, 2, 256) positions of ANCHOR_IMAGE's prompt, else
    None)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    embeds = (rng.standard_normal(FORWARD_SHAPE + (d,))
              * d ** -0.5).astype(np.float32)
    if not cfg.mrope_sections:
        return embeds, None
    pos = image_positions(*ANCHOR_IMAGE)
    return embeds, np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3,) + FORWARD_SHAPE))


@contextlib.contextmanager
def record_routes():
    """Inside the ``with``, every MoE layer's routing
    (:func:`repro_torch.models.moe.route`, as ``moe_apply`` calls it) is
    also appended, in call order, to the list it yields: that call's
    ``Routes`` with every tensor on the CPU."""
    from . import moe

    rec, route = [], moe.route

    def recording(*args, **kw):
        r = route(*args, **kw)
        rec.append(type(r)(*(t.detach().cpu() for t in r)))
        return r

    moe.route = recording
    try:
        yield rec
    finally:
        moe.route = route


def routes_digest(top_e: list, keep: list) -> dict:
    """A run's routes, one (G, gs, k) array of experts and one of keep
    flags an MoE layer in call order, as CRC-32s of their bytes (int32
    and uint8, C order) and each layer's count of dropped picks."""
    top_e = [np.asarray(t, dtype=np.int32) for t in top_e]
    keep = [np.asarray(t, dtype=np.uint8) for t in keep]
    return {"top_e_crc32": zlib.crc32(b"".join(t.tobytes() for t in top_e)),
            "keep_crc32": zlib.crc32(b"".join(t.tobytes() for t in keep)),
            "dropped": tuple(int(t.size - np.count_nonzero(t))
                             for t in keep)}


#: The training anchors' run: the reference train test's optimizer
#: settings (lr 1e-2, warmup 2) over TRAIN_STEPS steps (the cosine
#: schedule's total), SyntheticLM batches of TRAIN_SHAPE (global batch,
#: sequence) from data seed TRAIN_DATA_SEED, no remat.
TRAIN_STEPS = 5
TRAIN_SHAPE = (4, 128)
TRAIN_LR, TRAIN_WARMUP = 1e-2, 2
TRAIN_DATA_SEED = 0

#: Frozen JAX results (JAX 0.9 on the CPU), by arch id, for the reduced
#: config in float32: ``logits`` the first ANCHOR_VOCAB logits of each
#: ANCHOR_ROWS row of the forward, ``row_sums`` each such row summed over
#: the vocabulary (float64), ``greedy`` the GREEDY_STEPS tokens after the
#: prompt, ``min_top2_gap`` the smallest top-1/top-2 logit gap over the
#: greedy steps (how far the tokens are from a tie).  MoE archs also
#: hold ``routes``, the :func:`routes_digest` of the forward's routes,
#: and ``min_router_gap``, the smallest gap between consecutive router
#: probabilities among a token's k+1 largest over the forward and the
#: greedy run (the gap between the k-th and the (k+1)-th sets which
#: experts a token takes, the earlier gaps their order, which sets the
#: capacity ranks: how far the routes are from a tie).  The
#: modality-stub archs (qwen2-vl-2b, musicgen-large) take their forward
#: on :func:`anchor_embeds` (qwen2-vl with its image positions); their
#: greedy run is on the token prompt, through the embedding table.
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
    "arctic-480b": {
        "logits": (
            (
                2.1629040241241455, -0.1349015235900879, -0.19685451686382294,
                1.345310091972351, 0.12206169217824936, 1.1032320261001587,
                -0.888448178768158, -0.9779047966003418, -0.31686586141586304,
                0.9764801859855652, 0.5271244049072266, 0.8908029794692993,
                -0.4945211410522461, -0.9381948113441467, 0.6777616143226624,
                0.9854943156242371,
            ),
            (
                -0.9506109952926636, -0.6404778361320496, 1.7589112520217896,
                -0.7980386018753052, 0.37365487217903137, 0.8271952867507935,
                0.7228191494941711, -0.5523227453231812, -2.4738845825195312,
                1.4373841285705566, -0.5971943140029907, 0.49536803364753723,
                -0.3045083284378052, 0.7266222834587097, 0.09787053614854813,
                0.28051236271858215,
            ),
            (
                0.03892065957188606, 0.28279826045036316, -2.2622318267822266,
                -1.0553730726242065, -0.12840038537979126, 1.4216541051864624,
                1.642441987991333, -1.0370018482208252, 0.7179839015007019,
                -1.096649169921875, 0.03162466362118721, -2.5192453861236572,
                -1.0011112689971924, 0.9081714153289795, -0.03243251517415047,
                -0.6583240628242493,
            ),
            (
                -0.8748942613601685, 0.4688602387905121, 0.5378354787826538,
                -1.2734543085098267, -1.7066659927368164, 0.35733097791671753,
                -1.1084076166152954, -0.016520323231816292, 0.5139122605323792,
                -1.3747867345809937, -0.40830156207084656, -0.4403914213180542,
                -0.08923119306564331, 0.018350670114159584,
                -0.02321569249033928, 0.323639452457428,
            ),
            (
                -1.0907398462295532, -0.2672695517539978, -1.1416529417037964,
                0.4326294958591461, -1.420135498046875, 0.44087666273117065,
                0.059242431074380875, -0.08015534281730652, 1.1543241739273071,
                0.03557506203651428, -0.02314831130206585, -1.5352717638015747,
                0.1706317961215973, 0.5468906760215759, -0.9740517735481262,
                -1.2633861303329468,
            ),
        ),
        "row_sums": (
            -8.22543491795659, 47.14419371006079, 56.61049977806397,
            -23.8111996561056, -28.025449002627283,
        ),
        "greedy": (
            (284, 81, 340, 312, 424, 366, 476, 159),
            (38, 335, 251, 240, 9, 107, 251, 22),
        ),
        "min_top2_gap": 0.019951820373535156,
        "routes": {"top_e_crc32": 4157929482, "keep_crc32": 1229334007,
                   "dropped": (89, 62)},
        "min_router_gap": 1.4185905456542969e-05,
    },
    "xlstm-350m": {
        "logits": (
            (
                0.08039860427379608, -0.14982807636260986,
                -0.42218706011772156, -0.11725253611803055,
                -1.0850844383239746, 0.07804380357265472, -2.600151538848877,
                -1.662168025970459, -0.9310680627822876, 1.435336709022522,
                -1.978020429611206, 0.24042655527591705, 1.4247814416885376,
                0.4470435082912445, 0.3584800958633423, -0.8014637231826782,
            ),
            (
                -0.433256596326828, -0.42994415760040283, 1.0832918882369995,
                -0.6530484557151794, -0.45395955443382263, 0.787944495677948,
                0.014957700856029987, 0.43746066093444824, -1.1120071411132812,
                -0.5756264925003052, 0.6527352929115295, 0.8481848835945129,
                -0.32086145877838135, -0.12498282641172409, 0.3090960383415222,
                -2.868784189224243,
            ),
            (
                1.2101410627365112, -0.14954011142253876, -2.6938223838806152,
                0.6155507564544678, 0.1269616037607193, -0.7368388175964355,
                -1.0012867450714111, -1.352657675743103, -1.8943204879760742,
                -0.8201658129692078, -1.0532114505767822, -0.37537050247192383,
                -0.7188064455986023, -0.7716509103775024, -0.2535419464111328,
                0.4985203742980957,
            ),
            (
                -0.437237948179245, 1.7500685453414917, -1.414875864982605,
                0.09449228644371033, -0.6026197075843811, -1.510638952255249,
                1.6062471866607666, 0.23768733441829681, -1.5083796977996826,
                0.14809490740299225, -2.404463052749634, 1.5818088054656982,
                1.1495814323425293, 0.3680840730667114, -1.4962612390518188,
                -0.4128663241863251,
            ),
            (
                -0.4954891502857208, 1.0795398950576782, -0.7192461490631104,
                0.8896871209144592, 0.07945743948221207, 0.6969123482704163,
                -1.7024364471435547, 1.29616379737854, 2.0994608402252197,
                -0.7935486435890198, -0.5815390348434448, -0.0996699184179306,
                1.2014509439468384, 2.1067466735839844, -1.9902020692825317,
                -0.655558705329895,
            ),
        ),
        "row_sums": (
            -11.49403761792928, -5.529567928984761, -18.46375501481816,
            -10.135545266792178, -13.215889357496053,
        ),
        "greedy": (
            (278, 97, 408, 79, 142, 357, 330, 497),
            (320, 170, 192, 425, 25, 37, 479, 301),
        ),
        "min_top2_gap": 0.006448984146118164,
    },
    "jamba-v0.1-52b": {
        "logits": (
            (
                0.6944634318351746, -1.9813324213027954, 0.82293301820755,
                -0.574669599533081, 0.26646608114242554, 0.34925204515457153,
                -0.06097187474370003, 0.10220200568437576, -1.1361970901489258,
                -0.9792371988296509, -1.538264513015747, -2.770343542098999,
                1.8206212520599365, 0.3055424392223358, 0.10766877233982086,
                -0.16444888710975647,
            ),
            (
                -0.25584495067596436, -0.5064696073532104, -0.5168206691741943,
                0.5598534345626831, 0.7533002495765686, 1.8860485553741455,
                -0.8726992607116699, 0.23870933055877686, -1.1882734298706055,
                0.495685875415802, -0.4051576256752014, 1.39858078956604,
                0.13837504386901855, 0.0699097216129303, 2.4606099128723145,
                1.7304819822311401,
            ),
            (
                -0.3112870752811432, -0.9859935641288757, 0.4073054790496826,
                -0.38847970962524414, -0.4006657302379608, 0.4137333631515503,
                -0.14769861102104187, 1.159359335899353, -0.43011292815208435,
                0.9925343990325928, -0.37406855821609497, 2.990440845489502,
                -0.7645488381385803, 0.9980841279029846, 0.7612782716751099,
                1.2807270288467407,
            ),
            (
                -1.4659395217895508, -1.478812336921692, 1.1276788711547852,
                0.7631884813308716, -0.43427741527557373, -0.9342519640922546,
                -1.1121225357055664, 0.04990792274475098, 0.14302724599838257,
                -0.5071366429328918, -0.8352523446083069, -2.11557936668396,
                -0.08914441615343094, -0.524178683757782, 1.336144208908081,
                -0.3268577456474304,
            ),
            (
                -0.19286562502384186, 0.5802532434463501, 0.5273578763008118,
                0.12803520262241364, 0.39672452211380005, -1.0343453884124756,
                -0.2379869967699051, -1.4974414110183716, -2.6847665309906006,
                0.14576034247875214, 1.273730993270874, 0.09518236666917801,
                0.2752247452735901, -0.9302874207496643, -0.66072016954422,
                0.6703047156333923,
            ),
        ),
        "row_sums": (
            -29.46827564481646, 8.780671501997858, 16.04352737031877,
            8.086631895857863, 33.30093710892834,
        ),
        "greedy": (
            (151, 82, 139, 81, 36, 435, 169, 124),
            (382, 289, 443, 93, 210, 305, 247, 247),
        ),
        "min_top2_gap": 0.024606943130493164,
        "routes": {"top_e_crc32": 16891054, "keep_crc32": 892294608,
                   "dropped": (35, 89, 109, 64, 101, 42, 88, 16)},
        "min_router_gap": 4.112720489501953e-06,
    },
    "deepseek-v2-236b": {
        "logits": (
            (
                -0.3950040638446808, 1.1350476741790771,
                2.1169626712799072, -0.9651669859886169,
                0.5834409594535828, 0.3983478248119354,
                -0.5033479332923889, 0.23734165728092194,
                -1.2856565713882446, 0.38134655356407166,
                -0.370696097612381, 0.8459689021110535,
                1.1383801698684692, -0.16742776334285736,
                1.3502346277236938, 0.6351705193519592,
            ),
            (
                -0.3429378867149353, 0.9101924896240234,
                0.3028276562690735, -1.3171409368515015,
                0.7485150098800659, -0.1477939784526825,
                0.5914686918258667, -2.065798759460449,
                -0.1917155385017395, 2.589674472808838,
                0.4415253698825836, 0.37682977318763733,
                -0.6291587352752686, 1.4025681018829346,
                -0.37333571910858154, -0.05068036913871765,
            ),
            (
                -0.3452988862991333, -0.6765566468238831,
                1.1533218622207642, 0.7452966570854187,
                0.4904203414916992, -0.12983685731887817,
                0.8185197114944458, 1.39131760597229,
                1.5537831783294678, 2.2711963653564453,
                0.22312067449092865, -0.14303156733512878,
                0.5056459307670593, -0.3779924511909485,
                0.638672411441803, -0.7307015657424927,
            ),
            (
                0.660905122756958, -1.3793748617172241,
                -0.33405736088752747, -0.6575854420661926,
                -1.1169949769973755, 0.8553796410560608,
                0.8290801644325256, 1.4292010068893433,
                -1.759846568107605, 2.189646005630493,
                -1.7327101230621338, -0.6757285594940186,
                -1.071197509765625, 1.2562236785888672,
                0.26948875188827515, -0.9197391867637634,
            ),
            (
                0.017713163048028946, -0.48298826813697815,
                -0.46185746788978577, -0.06574515253305435,
                -0.6934379935264587, 1.0401278734207153,
                -0.9511673450469971, -1.266342282295227,
                -0.5081443190574646, -0.7629849910736084,
                -0.5705536603927612, -1.4625812768936157,
                -0.8173599243164062, -0.6885048747062683,
                -0.29457440972328186, -1.4061061143875122,
            ),
        ),
        "row_sums": (
            -9.030687343445607, 26.525001682690345,
            -5.961330897989683, -13.271974252536893,
            -16.86681791394949,
        ),
        "greedy": (
            (38, 226, 419, 448, 50, 448, 7, 489),
            (495, 373, 419, 107, 189, 280, 336, 302),
        ),
        "min_top2_gap": 0.008789539337158203,
        "routes": {"top_e_crc32": 3946592666, "keep_crc32": 3818974591,
                   "dropped": (107, 158)},
        "min_router_gap": 2.483278512954712e-05,
    },
    "qwen2-vl-2b": {
        "logits": (
            (
                -0.19900330901145935, -1.1687321662902832,
                0.4586206078529358, -0.5623308420181274,
                0.2647421061992645, -0.5384136438369751,
                -0.3293498158454895, 1.5068705081939697,
                -0.045347027480602264, 0.49473145604133606,
                -0.6856415271759033, 0.152474507689476,
                0.9138473868370056, 0.9033243656158447,
                -1.018069863319397, 0.14347894489765167,
            ),
            (
                0.8075576424598694, 0.06885617971420288,
                2.4128005504608154, -0.19102731347084045,
                -0.5721284747123718, 0.5264679193496704,
                -1.5822218656539917, 1.7557072639465332,
                0.2840701639652252, -2.5720789432525635,
                -1.195887804031372, -0.7302414178848267,
                -1.0956199169158936, -1.0573867559432983,
                -0.05969294533133507, 0.09616944938898087,
            ),
            (
                0.6812494397163391, -0.003383549163118005,
                0.7628888487815857, -0.4059928357601166,
                0.785465657711029, 0.1021580919623375,
                -0.2048357129096985, 2.322052478790283,
                -0.4425983726978302, -2.4895312786102295,
                0.30439332127571106, -1.5411738157272339,
                0.09450054168701172, 1.5344433784484863,
                0.8358172178268433, -1.8413567543029785,
            ),
            (
                0.9496157169342041, 0.2061329334974289,
                0.17699623107910156, 2.0899860858917236,
                0.37989768385887146, 0.28270483016967773,
                0.2955448031425476, 0.8017446398735046,
                -0.4989916980266571, -1.0482243299484253,
                -0.04339239001274109, -0.6756963729858398,
                0.2588542401790619, -1.6407153606414795,
                -0.3971256911754608, -0.6593562364578247,
            ),
            (
                0.3635888397693634, 2.568401575088501,
                -0.0812152847647667, 0.724350094795227,
                -0.7325361967086792, -0.6077273488044739,
                0.5389500856399536, 0.6495182514190674,
                0.44749772548675537, -1.4883465766906738,
                0.24445819854736328, -1.8847830295562744,
                -0.08694205433130264, -1.2526272535324097,
                -0.04241529107093811, -2.0515239238739014,
            ),
        ),
        "row_sums": (
            24.380413672770374, -7.288334527111147,
            36.358276224695146, 34.15468145348132,
            18.674728192097973,
        ),
        "greedy": (
            (98, 98, 98, 98, 98, 98, 98, 79),
            (223, 284, 340, 337, 337, 337, 337, 344),
        ),
        "min_top2_gap": 0.05159449577331543,
    },
    "musicgen-large": {
        "logits": (
            (
                0.023845618590712547, -0.5710961818695068,
                0.8165044188499451, -0.01292846817523241,
                0.23578792810440063, -0.26831406354904175,
                0.59807950258255, 0.052381567656993866,
                -0.6033962368965149, 0.8672772645950317,
                -0.35611918568611145, 1.2327455282211304,
                -0.20212915539741516, 2.0859851837158203,
                1.409427523612976, 0.5249767899513245,
            ),
            (
                -1.655595064163208, 0.5802968144416809,
                1.0668299198150635, 0.7031760215759277,
                -0.46963784098625183, -0.6236513257026672,
                0.22107335925102234, -0.34215468168258667,
                -1.3767778873443604, 0.5495648980140686,
                1.2111772298812866, 0.4342173933982849,
                0.10457813739776611, 1.8148669004440308,
                0.3974621593952179, 0.6236019730567932,
            ),
            (
                -1.6834068298339844, 0.6219652891159058,
                1.1249135732650757, 0.6777528524398804,
                -0.48943623900413513, -0.578204870223999,
                0.042808499187231064, -0.38559606671333313,
                -1.4872394800186157, 0.46547237038612366,
                1.378752589225769, 0.5200839638710022,
                -0.03682084009051323, 1.6277966499328613,
                0.48563966155052185, 0.6893408894538879,
            ),
            (
                -2.170626401901245, 1.0986714363098145,
                2.4020817279815674, -0.5001262426376343,
                0.46072322130203247, 0.10612323135137558,
                0.235371932387352, -1.1446994543075562,
                -0.5655677318572998, -0.9579955339431763,
                2.5695245265960693, 0.3045787215232849,
                0.8514286279678345, 1.5901989936828613,
                0.2831403315067291, 0.9262970685958862,
            ),
            (
                -0.9100840091705322, 0.8979632258415222,
                0.8025128245353699, -0.5196521282196045,
                0.5494245290756226, 0.20633266866207123,
                1.0679653882980347, -0.04893627017736435,
                -0.3055869936943054, -0.6231632232666016,
                0.7177886962890625, 1.1682153940200806,
                0.6478062272071838, 1.7966803312301636,
                0.6218534708023071, 0.998028576374054,
            ),
        ),
        "row_sums": (
            10.09701716573909, -22.017317259218544,
            -25.185864173574373, -31.858616209123284,
            6.877485464792699,
        ),
        "greedy": (
            (215, 215, 215, 215, 215, 215, 215, 198),
            (215, 215, 215, 215, 215, 215, 215, 198),
        ),
        "min_top2_gap": 0.046500205993652344,
    },
}


def train_run(arch: str, device="cuda") -> dict:
    """The training run behind ``TRAIN_ANCHORS[arch]`` on ``device``: the
    reduced float32 ``arch`` from :func:`jax_layout_params`, TRAIN_STEPS
    train steps (no remat) on ``SyntheticLM`` batches.  Returns each
    step's loss and global gradient norm, the first step's gradient norm
    of every leaf (float64, by leaf path) and the final parameters."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.sweep import resolve_device
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    from . import transformer as T

    dev = resolve_device(device)
    cfg = get_reduced_config(arch, dtype="float32")
    b, s = TRAIN_SHAPE
    ds = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b,
                                     seed=TRAIN_DATA_SEED))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                total_steps=TRAIN_STEPS)
    params = steps.trainable(T.to_device(
        T.params_from_jax(cfg, jax_layout_params(cfg)), dev))
    _, g0 = steps.value_and_grad(cfg, params,
                                 train.device_batch(ds.batch_at(0), dev))
    leaf = {k: float(v.double().norm()) for k, v in _flatten(g0)}
    step = steps.make_train_step(cfg, opt_cfg, remat=False)
    opt, losses, norms = adamw.init(opt_cfg, params), [], []
    for i in range(TRAIN_STEPS):
        params, opt, met = step(params, opt,
                                train.device_batch(ds.batch_at(i), dev))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "leaf_grad_norms": leaf,
            "params": params}


#: Frozen JAX results (JAX 0.9 on the CPU) of the training run above,
#: by arch id, for the reduced config in float32 from the anchor
#: weights: ``losses`` and ``grad_norms`` (global, before clipping)
#: of each step, ``leaf_grad_norms`` the first step's gradient norm of
#: each leaf by the port's leaf path (float64 norms).
TRAIN_ANCHORS: dict = {
    "qwen2-0.5b": {
        "losses": (
            6.4218430519104, 5.656156539916992, 4.568023681640625,
            4.633533000946045, 4.615225791931152,
        ),
        "grad_norms": (
            4.002308368682861, 3.335923433303833, 1.6981785297393799,
            2.7400460243225098, 1.0282502174377441,
        ),
        "leaf_grad_norms": {
            "embed/table": 2.106222512922615,
            "final_norm/scale": 0.10672363011927187,
            "layers/0/ffn/w_down": 1.3015783360771134,
            "layers/0/ffn/w_gate": 0.9211741115754624,
            "layers/0/ffn/w_up": 0.9028657099750501,
            "layers/0/mixer/b_k": 0.017645383071591216,
            "layers/0/mixer/b_q": 0.0669404900859079,
            "layers/0/mixer/b_v": 0.47878464138228277,
            "layers/0/mixer/w_k": 0.6766882153807973,
            "layers/0/mixer/w_o": 1.5672677984292318,
            "layers/0/mixer/w_q": 0.6460859251558816,
            "layers/0/mixer/w_v": 1.3868188524059688,
            "layers/0/norm1/scale": 0.16254538956642595,
            "layers/0/norm2/scale": 0.1186689767318958,
            "layers/1/ffn/w_down": 0.6973589077826373,
            "layers/1/ffn/w_gate": 0.4467875315301981,
            "layers/1/ffn/w_up": 0.5309440359436389,
            "layers/1/mixer/b_k": 0.00604080794979756,
            "layers/1/mixer/b_q": 0.020336226976594565,
            "layers/1/mixer/b_v": 0.20114498963392405,
            "layers/1/mixer/w_k": 0.17569359375561677,
            "layers/1/mixer/w_o": 0.9011127116627368,
            "layers/1/mixer/w_q": 0.17389573423211693,
            "layers/1/mixer/w_v": 0.8901690417858141,
            "layers/1/norm1/scale": 0.07340427541047065,
            "layers/1/norm2/scale": 0.06305279948450904,
        },
    },
    "gemma2-2b": {
        "losses": (
            5.613340377807617, 4.950395584106445, 4.325078010559082,
            4.4615678787231445, 4.422127723693848,
        ),
        "grad_norms": (
            3.1711528301239014, 2.042619466781616, 3.008746862411499,
            4.305829048156738, 2.682541608810425,
        ),
        "leaf_grad_norms": {
            "embed/table": 1.7592057262466956,
            "final_norm/scale": 0.07975489083599899,
            "layers/0/ffn/w_down": 0.7734208337778145,
            "layers/0/ffn/w_gate": 0.5101420901169371,
            "layers/0/ffn/w_up": 0.551796884770765,
            "layers/0/mixer/w_k": 0.4201690135101985,
            "layers/0/mixer/w_o": 1.073442967754556,
            "layers/0/mixer/w_q": 0.4165524099784435,
            "layers/0/mixer/w_v": 1.0229129400999328,
            "layers/0/norm1/scale": 0.10710454633794796,
            "layers/0/norm2/scale": 0.06887312398469593,
            "layers/0/post_norm1/scale": 0.09408245842787831,
            "layers/0/post_norm2/scale": 0.043009654404379385,
            "layers/1/ffn/w_down": 0.5604492468656013,
            "layers/1/ffn/w_gate": 0.34965098695245306,
            "layers/1/ffn/w_up": 0.3558907203996045,
            "layers/1/mixer/w_k": 0.16967866503602586,
            "layers/1/mixer/w_o": 0.7057862185499661,
            "layers/1/mixer/w_q": 0.17274340490256954,
            "layers/1/mixer/w_v": 0.7464917106345319,
            "layers/1/norm1/scale": 0.06568118665802249,
            "layers/1/norm2/scale": 0.04067836828076089,
            "layers/1/post_norm1/scale": 0.06118929063449079,
            "layers/1/post_norm2/scale": 0.03186282464306315,
            "layers/2/ffn/w_down": 0.4116071343809273,
            "layers/2/ffn/w_gate": 0.26772591361136894,
            "layers/2/ffn/w_up": 0.2846949513098666,
            "layers/2/mixer/w_k": 0.0966226227516146,
            "layers/2/mixer/w_o": 0.5074139946486274,
            "layers/2/mixer/w_q": 0.10271262204716777,
            "layers/2/mixer/w_v": 0.560803454100853,
            "layers/2/norm1/scale": 0.04804781809115674,
            "layers/2/norm2/scale": 0.03497619360268749,
            "layers/2/post_norm1/scale": 0.04780504845863328,
            "layers/2/post_norm2/scale": 0.029204816251767417,
            "layers/3/ffn/w_down": 0.351677646467878,
            "layers/3/ffn/w_gate": 0.26248730826862493,
            "layers/3/ffn/w_up": 0.2606201281455926,
            "layers/3/mixer/w_k": 0.07830575532567363,
            "layers/3/mixer/w_o": 0.41509200897460224,
            "layers/3/mixer/w_q": 0.07487049597900299,
            "layers/3/mixer/w_v": 0.39893707183063853,
            "layers/3/norm1/scale": 0.033224353432459164,
            "layers/3/norm2/scale": 0.037005237593813495,
            "layers/3/post_norm1/scale": 0.037589871986201874,
            "layers/3/post_norm2/scale": 0.023045946673472668,
        },
    },
}
