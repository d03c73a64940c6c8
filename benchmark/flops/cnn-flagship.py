"""Operations of the cnn-flagship cells' work, from shapes.

``round_flops``: the model FLOPs of one federated round, 3x the forward
(the backward ~2x) of every example of every local step of every station.
A forward of one example, at 2 FLOPs a multiply-add: each 3x3 SAME
convolution H x W x out x (9 x in), the first at the image's size and the
second after a 2x2 pool, and the dense layers in x out. Pooling, ReLU and
the softmax are left out. Compression adds no model FLOPs.
"""
ROUND_DTYPE = "bf16"


def forward_flops(model: dict) -> float:
    h, w, c = model["image_shape"]
    c0, c1 = model["conv_channels"]
    hidden, classes = model["dense_features"], model["num_classes"]
    conv0 = h * w * c0 * 9 * c * 2
    conv1 = (h // 2) * (w // 2) * c1 * 9 * c0 * 2
    dense0 = (h // 4) * (w // 4) * c1 * hidden * 2
    dense1 = hidden * classes * 2
    return float(conv0 + conv1 + dense0 + dense1)


def round_flops(config: dict, traffic: dict) -> float:
    fed = config["federation"]
    examples = fed["stations"] * fed["local_steps"] * fed["batch"]
    return 3.0 * forward_flops(config["model"]) * examples
