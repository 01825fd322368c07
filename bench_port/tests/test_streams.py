"""The rotated job streams (CPU): every sample of every rotation is the
source's sample of the mapped pts, and the first pictures of each
rotation decode, with the port's plain pixel decoder, to libavcodec's
pictures of the source."""

import json
import pathlib

import pytest

from bench_port import digests, streams

HERE = pathlib.Path(__file__).resolve().parents[1]
RENDERS = ("synth_1800.mp4", "synth_1800_1080p.mp4")


@pytest.mark.parametrize("name", RENDERS)
def test_rotations_keep_every_sample(name, tmp_path):
    src = streams.read_mp4(HERE / "data" / name)
    by_pts = {s.pts: src.data[s.offset : s.offset + s.size] for s in src.samples}
    for r in range(len(src.gops())):
        rot = streams.write_rotated(src, tmp_path / f"r{r}.mp4", r)
        got = streams.read_mp4(tmp_path / f"r{r}.mp4")
        assert [len(g) for g in got.gops()] == [len(g) for g in src.gops()[r:] + src.gops()[:r]]
        assert sorted(rot.to_source.values()) == sorted(by_pts)
        for s in got.samples:
            assert got.data[s.offset : s.offset + s.size] == by_pts[rot.source_pts(s.pts)]


@pytest.mark.parametrize("r", range(8))
def test_rotation_decodes_to_source_pictures(r, tmp_path):
    from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder

    name = RENDERS[0]
    clip = pathlib.Path(name).stem
    pictures = json.loads((HERE / "ref" / "pictures" / f"{clip}.json").read_text())["frames"]
    rot = streams.write_rotated(streams.read_mp4(HERE / "data" / name), tmp_path / "r.mp4", r)
    d = Mp4Demuxer(str(tmp_path / "r.mp4"))
    dec = PixelDecoder(d.extradata(), device="cpu")
    dec.send(d.read_sample(0), d.sample(0).pts)  # the rotated stream's first IDR
    dec.flush()
    pts, y, u, v = dec.pop(d.width, d.height)
    dec.close()
    d.close()
    assert digests.picture(y, u, v) == pictures[str(rot.source_pts(pts))]
