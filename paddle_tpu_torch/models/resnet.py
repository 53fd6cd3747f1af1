"""ResNet image models (the port of ``paddle_tpu.models.resnet``;
reference ``benchmark/fluid/resnet.py``).

The builders are the JAX package's, op for op, so both packages build the
same NCHW IR.  In ResNet-50 every bottleneck puts its stride on the 1x1
conv, so all sixteen 3x3 convs are stride 1, pad 1, no bias, each feeding
a ``batch_norm`` with ReLU: the shape family of the hand-written
``conv3x3_bn_act`` kernel (``kernels/conv3x3.py``), which runs them on an
inference program with the batch norm folded.
"""

from __future__ import annotations

from paddle_tpu_torch import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(input=input, filter_size=filter_size,
                         num_filters=ch_out, stride=stride, padding=padding,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None)
    return input


def basicblock(input, ch_out, stride):
    short = shortcut(input, ch_out, stride)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None)
    return layers.relu(short + conv2)


def bottleneck(input, ch_out, stride):
    short = shortcut(input, ch_out * 4, stride)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None)
    return layers.relu(short + conv3)


def layer_warp(block_func, input, ch_out, count, stride):
    res_out = block_func(input, ch_out, stride)
    for _ in range(count - 1):
        res_out = block_func(res_out, ch_out, 1)
    return res_out


def resnet_imagenet(input, class_dim, depth=50):
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim, depth=32):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def resnet_train_program(batch_size, class_dim=1000, depth=50,
                         image_shape=(3, 224, 224)):
    """Training graph: returns (avg_cost, accuracy, feed names)."""
    image = layers.data(name="image", shape=[batch_size] + list(image_shape),
                        dtype="float32", append_batch_size=False)
    label = layers.data(name="label", shape=[batch_size, 1], dtype="int64",
                        append_batch_size=False)
    predict = resnet_imagenet(image, class_dim, depth=depth)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, ["image", "label"]


def conv3x3_bn_relu_chains(program):
    """The ``(conv2d, batch_norm, relu)`` ops of ``program``'s global block
    that ``kernels.conv3x3_bn_act`` computes in one launch, in program
    order: a 3x3 conv of stride 1, padding 1, no dilation, one group and
    no bias whose output feeds only a batch norm, whose output feeds only
    a ReLU.  An inference program of ResNet-50 has sixteen (every
    bottleneck's middle conv); a training program none, as its grad ops
    read the same variables."""
    ops = program.global_block().ops
    readers = {}
    for op in ops:
        for n in op.input_arg_names:
            readers.setdefault(n, []).append(op)

    def only_reader(name, op_type, slot):
        found = readers.get(name, [])
        if len(found) == 1 and found[0].type == op_type and \
                found[0].input(slot) == [name]:
            return found[0]
        return None

    chains = []
    block = program.global_block()
    for conv in ops:
        if conv.type != "conv2d" or \
                tuple(block.var(conv.input("Filter")[0]).shape[2:]) != \
                (3, 3) or list(conv.attr("strides", [1, 1])) != [1, 1] or \
                list(conv.attr("paddings", [0, 0])) != [1, 1] or \
                list(conv.attr("dilations", [1, 1])) != [1, 1] or \
                (conv.attr("groups", 1) or 1) != 1:
            continue
        bn = only_reader(conv.output("Output")[0], "batch_norm", "X")
        relu = bn and only_reader(bn.output("Y")[0], "relu", "X")
        if relu is not None:
            chains.append((conv, bn, relu))
    return chains
