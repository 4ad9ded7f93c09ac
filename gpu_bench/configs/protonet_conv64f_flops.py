"""Model FLOPs of one segment through Conv64F with its logits head, from
the shapes (2 per multiply-add; BatchNorm, activations and pools are not
counted, as ``torch.utils.flop_counter`` does not count them).

Four 3×3 convolutions of 64 channels (the first from the input's), each
at the map a 3×3 stride-3 floor pool leaves after the one before, then the
linear layer from the flattened last map (64 at ``[1, 128, 157]``) to 1600.
About 0.2 GFLOP at ``[1, 128, 157]``.
"""

WIDTH = 64
LOGITS = 1600


def segment_flops(config: dict) -> float:
    c, h, w = config["spec_shape"]
    total, cin = 0, c
    for _ in range(4):
        total += 2 * 9 * cin * WIDTH * h * w
        h, w = h // 3, w // 3
        cin = WIDTH
    total += 2 * WIDTH * h * w * LOGITS
    return float(total)
