"""VGG-16 with batch norm and dropout (the port of
``paddle_tpu.models.vgg``; reference ``benchmark/fluid/vgg.py``), built
op for op as the JAX package builds it."""

from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch import nets


def vgg16_bn_drop(input):
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return fc2


def vgg_train_program(batch_size, class_dim=10, image_shape=(3, 32, 32)):
    image = layers.data(name="image", shape=[batch_size] + list(image_shape),
                        dtype="float32", append_batch_size=False)
    label = layers.data(name="label", shape=[batch_size, 1], dtype="int64",
                        append_batch_size=False)
    net = vgg16_bn_drop(image)
    predict = layers.fc(input=net, size=class_dim, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, ["image", "label"]
