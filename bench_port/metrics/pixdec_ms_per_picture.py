"""The pixel decoder (codec/pixrec.py: syntax on the host, upload, K8-K10,
the copy out, four ranges in threads): the pipeline's
`StageTimers.pixel_decode` (the stage's wall less the oracle's calls),
per picture decoded (dependency and inference pictures)."""


def read(run):
    s = sum(j.result.timers.pixel_decode for j in run["jobs"])
    if not run["pictures"] or s <= 0:
        return None
    return 1e3 * s / run["pictures"]
