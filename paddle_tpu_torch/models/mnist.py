"""MNIST convnet (the port of ``paddle_tpu.models.mnist``; reference
``benchmark/fluid/mnist.py``), built op for op as the JAX package builds
it."""

from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch import nets


def cnn_model(data):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv_pool_2, size=10, act="softmax")


def mnist_train_program(batch_size):
    image = layers.data(name="pixel", shape=[batch_size, 1, 28, 28],
                        dtype="float32", append_batch_size=False)
    label = layers.data(name="label", shape=[batch_size, 1], dtype="int64",
                        append_batch_size=False)
    predict = cnn_model(image)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, ["pixel", "label"]
