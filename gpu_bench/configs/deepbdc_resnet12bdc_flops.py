"""Model FLOPs of one segment through resnet12Bdc and its BDC head, from
the shapes (2 per multiply-add; BatchNorm, activations and pools are not
counted, as ``torch.utils.flop_counter`` does not count them).

Per stage at an h × w map: three 3×3 convolutions (cin → planes, then
planes → planes twice) and the 1×1 residual convolution (cin → planes),
then a 2×2 floor pool after stages 1–3; the head's 1×1 reduction (640 →
d) and the gram of the d × M map (M = h·w), 2·d²·M.  About 20.2 GFLOP at
``[1, 128, 157]`` with d = 64.
"""

PLANES = (64, 160, 320, 640)


def segment_flops(config: dict) -> float:
    c, h, w = config["spec_shape"]
    d = int(config["backbone"]["kwargs"]["reduce_dim"])
    total, cin = 0, c
    for i, planes in enumerate(PLANES):
        hw = h * w
        total += 2 * 9 * cin * planes * hw + 2 * 2 * 9 * planes * planes * hw
        total += 2 * cin * planes * hw
        if i < len(PLANES) - 1:
            h, w = h // 2, w // 2
        cin = planes
    m = h * w
    total += 2 * PLANES[-1] * d * m + 2 * d * d * m
    return float(total)
