"""fly_image.roofline_pct: the least time the H100 needs for the image-lerp
fly work of the traced pairs (stereobench.roofline_fly_image.
fly_image_seconds: the no-volume schedule's launches of PatchMatch
Stereo's own data term, K6 and its stride-2 form, counted from the
configuration and the frame) over the device time of the fly kernel's
family, in %: with fly_lerp "image" every launch of that family is K6."""

from stereobench import roofline, roofline_fly_image


def read(trace):
    measured = trace.family_s("fly_cost")
    if measured <= 0:
        return None
    e = trace.engine
    if trace.warm_iters is not None:
        e = roofline.warm_engine(e, trace.warm_iters)
    least = roofline_fly_image.fly_image_seconds(e, *trace.frame)
    if least is None:
        return None
    return 100.0 * trace.pairs * least / measured
