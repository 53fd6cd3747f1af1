"""Model programs of the port: the generative LM (:mod:`gen_lm`,
:mod:`gen_lm_long`), the Transformer (:mod:`transformer`), the conv
zoo (:mod:`resnet`, :mod:`vgg`, :mod:`mnist`), the Wide & Deep CTR
model (:mod:`wide_and_deep`), the stacked dynamic-LSTM sentiment
classifier (:mod:`stacked_lstm`) and the attention seq2seq NMT model
(:mod:`seq2seq`), with the zoo's small smoke-test programs
(:func:`build_train_program`).  ``compile_zoo_step`` waits for the
captured step (ROADMAP queue 1 item 5b)."""

from paddle_tpu_torch.models import (gen_lm, gen_lm_long, mnist, resnet,
                                     seq2seq, stacked_lstm, transformer, vgg,
                                     wide_and_deep)

__all__ = ["gen_lm", "gen_lm_long", "mnist", "resnet", "seq2seq",
           "stacked_lstm", "transformer", "vgg", "wide_and_deep",
           "ZOO_MODELS", "build_train_program", "synth_feed"]

#: zoo model names accepted by :func:`build_train_program` (and by
#: ``python -m paddle_tpu_torch lint --zoo``; the port's analysis and
#: optimization tests iterate exactly this list)
ZOO_MODELS = ("mnist", "resnet", "vgg", "transformer", "seq2seq",
              "stacked_lstm", "gen_lm", "gen_lm_long", "wide_and_deep")


def build_train_program(name, backward=True):
    """Build one zoo model's forward(+backward+optimizer) program with
    small smoke-test dimensions.

    Returns ``(main_program, startup_program, feed_names, fetch_names)``
    — ``feed_names`` is None when the model builds its own feed vars
    (the analyzer then infers them from ``is_data``).  The same programs
    as the JAX package's ``build_train_program`` (the same dict, ignoring
    ``creation_site``), shared by ``python -m paddle_tpu_torch lint
    --zoo``, ``opt --zoo`` and the tests.
    """
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if name == "mnist":
            cost, acc, feeds = mnist.mnist_train_program(8)
            fetches = [cost.name, acc.name]
        elif name == "resnet":
            cost, acc, feeds = resnet.resnet_train_program(
                2, class_dim=10, depth=18, image_shape=(3, 32, 32))
            fetches = [cost.name, acc.name]
        elif name == "vgg":
            cost, acc, feeds = vgg.vgg_train_program(2, class_dim=10)
            fetches = [cost.name, acc.name]
        elif name == "transformer":
            hp = transformer.ModelHyperParams()
            hp.d_model, hp.d_inner_hid, hp.n_layer, hp.n_head = 32, 64, 1, 2
            hp.d_key = hp.d_value = 16
            hp.src_vocab_size = hp.trg_vocab_size = 64
            hp.max_length = 16
            cost, _ = transformer.transformer(2, 8, 8, hp)
            feeds, fetches = None, [cost.name]
        elif name == "seq2seq":
            cost, _ = seq2seq.seq_to_seq_net(
                16, 16, emb_dim=8, encoder_size=8, decoder_size=8)
            feeds, fetches = None, [cost.name]
        elif name == "stacked_lstm":
            cost, acc, _ = stacked_lstm.stacked_lstm_net(
                dict_size=16, emb_dim=8, hidden_dim=8, n_layers=2)
            feeds, fetches = None, [cost.name, acc.name]
        elif name == "gen_lm":
            hp = gen_lm.GenConfig()
            hp.vocab_size, hp.d_model, hp.d_ffn = 32, 16, 32
            hp.n_head = hp.n_layer = 2
            hp.d_head, hp.max_len = 8, 16
            cost, feeds = gen_lm.gen_lm_train_program(2, 8, hp)
            fetches = [cost.name]
        elif name == "wide_and_deep":
            cost, acc, feeds = wide_and_deep.wide_and_deep_train_program(
                4, vocab_size=16, num_slots=2, emb_dim=4, dense_dim=4,
                hidden=8)
            fetches = [cost.name, acc.name]
        elif name == "gen_lm_long":
            # flagship long-context geometry: max_len stays at the
            # GenLongConfig 256 (the gated axis); the rest shrinks to
            # smoke-test scale like the base gen_lm entry
            hp = gen_lm_long.GenLongConfig()
            hp.vocab_size, hp.d_model, hp.d_ffn = 32, 16, 32
            hp.n_head = hp.n_layer = 2
            hp.d_head = 8
            cost, feeds = gen_lm_long.gen_lm_long_train_program(2, 16, hp)
            fetches = [cost.name]
        else:
            raise ValueError(
                f"unknown zoo model {name!r}; expected one of "
                f"{ZOO_MODELS}")
        if backward:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, feeds, fetches


def synth_feed(main_program, feed_names=None, batch=2):
    """Synthetic (zero-filled) feed dict for a zoo main program: one
    step of it runs without a dataset.  Zeros are valid everywhere the zoo reads labels or token
    ids (class/token 0 exists); dynamic dims synthesize as ``batch``.
    ``feed_names=None`` falls back to the program's ``is_data`` vars
    (models that build their own feed layers)."""
    block = main_program.global_block()
    if feed_names is None:
        feed_names = [v.name for v in block.vars.values()
                      if getattr(v, "is_data", False)]
    from paddle_tpu_torch.io import synth_feed_value

    feed = {}
    for name in feed_names:
        var = block.var(name)
        shape = tuple(batch if d is None or int(d) < 0 else int(d)
                      for d in (var.shape or (batch,)))
        feed[name] = synth_feed_value(shape, var.dtype or "float32")
    return feed
