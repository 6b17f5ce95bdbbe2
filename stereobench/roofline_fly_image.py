"""The least time the H100 could take for a pair's no-volume window cost
with PatchMatch Stereo's own data term (fly_lerp "image", kernel K6 and its
stride-2 form), counted from the configuration and the frame's shape
alone: a frozen copy of the program's utils/roofline image-lerp count on
stereobench.roofline's launches (fly_plan) and in-image samples, the same
count whatever implements the data term.  The peaks are
stereobench.roofline's.
"""

from __future__ import annotations

from . import roofline

# the fly kernel's in-range sample in "image" mode adds to the window
# sample's 5 operations the warp (other_x, fw, 1 - fw), four channel lerps
# (3 each: the three colours and the gradient), three |q - lerp| (2 each),
# their two adds and 1/3, |grad diff| (a subtract and an abs) and the mix
# (two mins, two multiplies, an add); every in-image sample is counted as
# in range
FLY_IMAGE_FLOPS_IN_RANGE = 3 + 12 + 6 + 3 + 2 + 5


def fly_image_seconds(e: dict, h: int, w: int) -> float | None:
    """The least time of one pair's fly-kernel launches in image-lerp mode
    (roofline.fly_plan), None unless the configuration holds no volume and
    lerps in image space: per launch K * in-image samples at its stride *
    (FLOPS_IN_IMAGE + FLY_IMAGE_FLOPS_IN_RANGE) operations; bytes: every
    level's views of both images (FLY_PLANE_BYTES a pixel: u8 BGR and the
    f32 gradient) read once, the candidate planes read and their costs
    written."""
    if e["precompute_volume"] or e["fly_lerp"] != "image":
        return None
    launches = roofline.fly_plan(e)
    if not launches:
        return None
    planes = sum(2 * hs * ws * roofline.FLY_PLANE_BYTES
                 for hs, ws, _ in roofline.level_shapes(e, h, w))
    return roofline._launches_seconds(
        e, h, w, launches, planes,
        roofline.FLOPS_IN_IMAGE + FLY_IMAGE_FLOPS_IN_RANGE)
