"""The oracle (models/yolov4.py `YoloDetector`: preprocessing, YOLOv4-608,
decoding, NMS by K5): a host clock around the harness's detector
callable, which the pipeline calls one frame at a time, per frame."""


def read(run):
    if not run["oracle_frames"]:
        return None
    return 1e3 * sum(j.oracle_s for j in run["jobs"]) / run["oracle_frames"]
