"""Offline accuracy knob sweep over one cached BlobNet forward pass (the
PyTorch port's counterpart of examples/sweep_accuracy.py):

    python -m cova_tpu_torch.examples.sweep_accuracy [--weights W.npz]
        [--nnz] [--signed] [--grid] [--wide] [--video V.mp4]
        [--dataset synth] [--gt GT.csv] [--device cpu] [--max-frames N]

Almost all of an end-to-end accuracy run (entropy decode, the BlobNet
forward pass, pixel decode, the oracle detector) is invariant across
the knobs worth sweeping (mask_threshold, cc_threshold, tracker and
selector settings). This harness exploits two invariances:

  * BlobNet probabilities depend only on the weights and the metadata,
    so they are computed once per weights file (compressed_probs_step,
    on --device: the card unless told otherwise) and every threshold /
    tracker configuration re-runs only the host side: CC -> SORT ->
    frame selector -> aggregator -> metrics;
  * the stand-in oracle detector is a deterministic per-frame function
    of the pixels, so the detections the selective pixel stage would
    produce at a selected frame are EXACTLY the ground-truth rows at
    that frame's timestamp (--gt, the naive pipeline's dnn.csv) — no
    pixel decode is needed, so the harness runs where the codec has no
    pixel decoder.

The host replay mirrors CovaPipeline._run's host-tracking path line for
line (same chunk interleaving, same pts domains, same aggregator
delivery order), so its CSVs equal a full pipeline run's on the same
probabilities' masks (tests/test_torch_sweep.py holds them byte for
byte).

The defaults are the committed synth render (cova_tpu_torch/data/
synth_1800.mp4, examples/make_synth.py v6, seed 11), its ground truth
golden/synth/dnn_gt.csv and the synth-trained weights, scored at the
synth operating point; the demo clip of the JAX example is not in the
repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import math
import os
import pathlib
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
SYNTH_VIDEO = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
SYNTH_GT = REPO / "golden" / "synth" / "dnn_gt.csv"
# Probabilities cached per weights file, video and torch device; never
# the JAX example's cache, whose files come from another backend.
CACHE_DIR = pathlib.Path(tempfile.gettempdir()) / "cova_torch_sweep_cache"
# Each dataset's committed operating point (ACCURACY.md; the synth one is
# examples/reproduce_synth.py's).
OPERATING_POINTS = {
    "demo": dict(cc_threshold=3),
    "synth": dict(mask_threshold=0.6, cc_threshold=2, min_hits=40, max_age=45),
}


class SweepContext:
    """Everything invariant across sweep configurations for one video:
    range geometry, decoded metadata, ground-truth detections. `device`
    is where `probs` runs BlobNet (the card by default)."""

    def __init__(
        self,
        video: str = str(SYNTH_VIDEO),
        gt_csv=SYNTH_GT,
        num_ranges: int = 4,
        timestep: int = 4,
        fps: float = 30.0,
        decode_threads: int = 16,
        max_frames: int | None = None,
        dataset: str = "synth",
        device="cuda",
    ):
        from cova_tpu_torch.aggregator import BoxRec
        from cova_tpu_torch.codec import Mp4Demuxer
        from cova_tpu_torch.query.metrics import load_boxes_csv

        self.video = str(video)
        self.num_ranges = num_ranges
        self.timestep = timestep
        self.fps = fps
        self.dataset = dataset  # query config key (query/datasets.py)
        self.device = device

        demux = Mp4Demuxer(self.video)
        self.mb_h, self.mb_w = demux.mb_height, demux.mb_width
        tsc = float(demux.timescale)
        self.duration = (
            demux.sample(demux.num_samples - 1).pts / tsc + 1.0 / fps
        )

        # Range geometry — CovaPipeline._range_bounds + _run setup.
        gops = demux.gops()
        per = max(1, math.ceil(len(gops) / num_ranges))
        bounds = []
        for i in range(0, len(gops), per):
            chunk = gops[i : i + per]
            bounds.append(
                (chunk[0].first_sample, sum(g.num_samples for g in chunk))
            )
        while len(bounds) < num_ranges:
            bounds.append((demux.num_samples, 0))
        self.bounds = bounds[:num_ranges]
        if max_frames:
            # Same per-range clamp as CovaPipeline.run(max_frames=...).
            self.bounds = [(s, min(c, max_frames)) for s, c in self.bounds]

        all_pts = np.sort(
            np.array(
                [demux.sample(i).pts for i in range(demux.num_samples)],
                dtype=np.int64,
            )
        )
        pts_sec = all_pts / tsc
        if len(pts_sec) == 0:
            pts_sec = np.zeros(1)
        self.pts_sec = np.concatenate(
            [pts_sec, pts_sec[-1] + np.arange(1, len(self.bounds) + 2) / fps]
        )
        self.range_starts = [float(self.pts_sec[s]) for s, _ in self.bounds]

        self.disp = [
            demux.display_order(s, c) if c else np.zeros(0, np.int32)
            for s, c in self.bounds
        ]
        self.pos_of = []
        for ri, (s_, c_) in enumerate(self.bounds):
            m = {}
            for rel, si in enumerate(self.disp[ri]):
                m[int(si)] = s_ + rel
            self.pos_of.append(m)

        # Encoded-frame info for the selectors (decode order) and the
        # sample -> presentation-seconds map for the GT lookup.
        self.frame_info = []  # per range: [(sample_index, rank_pts, keyframe)]
        self.sample_sec = {}
        for ri, (start, count) in enumerate(self.bounds):
            rows = []
            for si in range(start, start + count):
                info = demux.sample(si)
                rows.append((si, self.pos_of[ri][si] / fps, info.keyframe))
                self.sample_sec[si] = info.pts / tsc
            self.frame_info.append(rows)

        # Decode all metadata once (display order per range, 4 channels —
        # 3-channel consumers slice; the packed bytes are identical).
        # Signed-MV metadata (the contract-ablation variant) is decoded
        # lazily on first use.
        self._decode_threads = decode_threads
        self.metadata = self._decode_metadata(demux, signed_mv=False)
        self._signed_metadata = None
        demux.close()

        # Ground-truth detections, twice: the frame lookup needs keys
        # EXACTLY equal to pts/timescale, so it parses round-trip
        # (`float`); the metric evaluation must match the JAX package's
        # bit for bit, which reads with pandas' default converter (up to
        # 1 ulp lossy) — so parse_query gets the pandas-parsed frame.
        self.gt_df = load_boxes_csv(gt_csv)
        gt_exact = load_boxes_csv(gt_csv, parse=float)
        conf = gt_exact.columns.get("confidence")
        self.gt_by_ts = {}
        for i, ts in enumerate(gt_exact.index.tolist()):
            self.gt_by_ts.setdefault(ts, []).append(
                BoxRec(
                    left=float(gt_exact["left"][i]),
                    top=float(gt_exact["top"][i]),
                    width=float(gt_exact["width"][i]),
                    height=float(gt_exact["height"][i]),
                    area=float(gt_exact["area"][i]),
                    track_id=None,
                    timestamp=ts,
                    class_id=int(gt_exact["class_id"][i]),
                    confidence=float(conf[i])
                    if conf is not None and not np.isnan(conf[i])
                    else None,
                )
            )
        self._probs_cache = {}

    def _decode_metadata(self, demux, signed_mv: bool):
        out_all = []
        for ri, (start, count) in enumerate(self.bounds):
            out = np.zeros((count, self.mb_h, self.mb_w, 4), np.uint8)
            if count:
                demux.entropy_decode_packed(
                    self.disp[ri], channels=4, threads=self._decode_threads,
                    out=out, signed_mv=signed_mv,
                )
            out_all.append(out)
        return out_all

    def metadata_for(self, signed_mv: bool):
        if not signed_mv:
            return self.metadata
        if self._signed_metadata is None:
            from cova_tpu_torch.codec import Mp4Demuxer

            demux = Mp4Demuxer(self.video)
            self._signed_metadata = self._decode_metadata(demux, True)
            demux.close()
        return self._signed_metadata

    def cache_file(self, weights_path, use_nnz: bool, batch_frames: int,
                   signed_mv: bool) -> pathlib.Path:
        """Where `probs` keeps its result on disk: keyed on the weights
        file's identity (a retrain invalidates it), the video, the ranges,
        the metadata contract and the torch device."""
        import torch

        st = os.stat(weights_path)
        tag = hashlib.sha1(
            f"{weights_path}:{st.st_mtime_ns}:{st.st_size}:{use_nnz}:"
            f"{batch_frames}:{self.video}:{self.bounds}:{signed_mv}:"
            f"torch-{torch.device(self.device)}".encode()
        ).hexdigest()[:16]
        return CACHE_DIR / f"probs_{tag}.npz"

    # ------------------------------------------------------------------
    def probs(self, weights_path, use_nnz: bool = False,
              batch_frames: int = 128, signed_mv: bool = False,
              cache: bool = True):
        """Per-range stride-1 window probabilities (wmax1, H, W) f32 for
        one weights file, computed on the context's device with the
        pipeline's exact chunking so thresholding them reproduces the
        pipeline's masks bit-for-bit. With `cache`, they are kept on disk
        (`cache_file`) and read back from there."""
        key = (str(weights_path), use_nnz, batch_frames, signed_mv)
        if key in self._probs_cache:
            return self._probs_cache[key]
        import torch

        device = torch.device(self.device)
        cache_file = None
        if cache:
            cache_file = self.cache_file(weights_path, use_nnz, batch_frames, signed_mv)
            if cache_file.exists():
                d = np.load(cache_file)
                out = [d[f"r{i}"] for i in range(self.num_ranges)]
                self._probs_cache[key] = out
                return out

        from cova_tpu_torch.config import (
            CompressedStageConfig,
            CovaConfig,
            ParallelConfig,
            VideoConfig,
        )
        from cova_tpu_torch.models.blobnet import (
            BlobNetConfig,
            convert_flax_variables,
            create_blobnet,
        )
        from cova_tpu_torch.pipeline.compressed import (
            compressed_probs_step,
            exact_float32,
        )

        exact_float32(device)
        nch = 4 if use_nnz else 3
        model, _ = create_blobnet(
            torch.Generator().manual_seed(0), BlobNetConfig(in_channels=nch), device
        )
        with np.load(weights_path) as data:
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
        model.load_state_dict(convert_flax_variables(arrays))
        cfg = CovaConfig(
            video=VideoConfig(timestep=self.timestep, fps=self.fps),
            compressed=CompressedStageConfig(
                batch_frames=batch_frames, use_nnz_channel=use_nnz,
                signed_mv=signed_mv,
            ),
            parallel=ParallelConfig(num_ranges=self.num_ranges),
        )

        metadata = self.metadata_for(signed_mv)
        t = self.timestep
        f = batch_frames
        wmax = [max(0, c - t + 1) for _, c in self.bounds]
        longest_w = max(wmax, default=0)
        n_chunks = -(-longest_w // f) if longest_w > 0 else 0
        nf_chunk = f + t - 1
        out = [
            np.zeros((w, self.mb_h, self.mb_w), np.float32) for w in wmax
        ]
        for chunk_i in range(n_chunks):
            win0 = chunk_i * f
            off = win0
            meta_chunk = np.zeros(
                (self.num_ranges, nf_chunk, self.mb_h, self.mb_w, nch),
                np.uint8,
            )
            if signed_mv:
                meta_chunk[..., 1:3] = 128  # offset-128 zero motion
            live = []
            for ri, (start, count) in enumerate(self.bounds):
                n = min(nf_chunk, count - off)
                if win0 >= wmax[ri] or n <= 0:
                    continue
                meta_chunk[ri, :n] = metadata[ri][off : off + n, :, :, :nch]
                live.append(ri)
            probs = compressed_probs_step(
                model, cfg, torch.from_numpy(meta_chunk).to(device)
            ).cpu().numpy().reshape(self.num_ranges, f, self.mb_h, self.mb_w)
            for ri in live:
                k = min(f, wmax[ri] - win0)
                out[ri][win0 : win0 + k] = probs[ri, :k]
        if cache_file is not None:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache_file, **{f"r{i}": a for i, a in enumerate(out)})
        self._probs_cache[key] = out
        return out

    # ------------------------------------------------------------------
    def run_config(self, probs, cfg, out_dir=None, ts_start=0.0, ts_end=None):
        """Replay the pipeline's host side for one configuration.

        probs: the per-range stride-1 window probabilities from
        `self.probs(...)`; cfg: a CovaConfig. Returns the report dict of
        reproduce_accuracy (metrics + filter rates + dead tracks).
        ts_start/ts_end window the metric evaluation (held-out tuning:
        tune knobs scoring only the training prefix, evaluate the unseen
        suffix — query/metrics.py parse_query)."""
        from cova_tpu_torch.aggregator import Associator
        from cova_tpu_torch.query.datasets import DATASETS
        from cova_tpu_torch.query.metrics import load_cova, parse_query
        from cova_tpu_torch.scheduler import FrameSelector
        from cova_tpu_torch.tracker.host import HostSort, cc_boxes

        t = cfg.video.timestep
        g = cfg.compressed.gamma
        f = cfg.compressed.batch_frames
        fps = cfg.video.fps
        bounds = self.bounds
        pts_sec = self.pts_sec

        tmp = None
        if out_dir is None:
            tmp = tempfile.TemporaryDirectory()
            out_dir = tmp.name
        agg = Associator(out_dir, cfg.aggregator)
        agg.set_ranges(self.range_starts)
        dead_count = [0]
        trackers_by_start = {}

        def on_dead_factory(range_start, sample_start):
            def cb(rec):
                dead_count[0] += 1
                ht = trackers_by_start[range_start]
                oldest = ht.oldest

                def sec(frame_idx):
                    return float(
                        pts_sec[
                            min(
                                sample_start + int(round(frame_idx)),
                                len(pts_sec) - 1,
                            )
                        ]
                    )

                oldest_s = sec(oldest) if math.isfinite(oldest) else 1e18
                rec = dataclasses.replace(
                    rec,
                    start_ts=sec(rec.start_ts),
                    end_ts=sec(rec.end_ts),
                    history=[(sec(fi), box) for fi, box in rec.history],
                )
                agg.submit_track(range_start, oldest_s, rec)

            return cb

        pix_jobs = [[] for _ in bounds]
        trackers, selectors = [], []
        for ri, (start, count) in enumerate(bounds):
            rs = self.range_starts[ri]
            ht = HostSort(cfg.sort, on_dead=on_dead_factory(rs, start))
            trackers_by_start[rs] = ht
            trackers.append(ht)

            def mk_seen(ht=ht, start=start):
                return lambda pts: ht.mark_seen(round(pts * fps) - start)

            def mk_emit(ri=ri):
                return lambda frames: pix_jobs[ri].extend(frames)

            selectors.append(
                FrameSelector(
                    cfg.selector,
                    cfg.sort,
                    fps=fps,
                    mark_seen=mk_seen(),
                    emit=mk_emit(),
                )
            )
        for ri in range(len(bounds)):
            for si, rank_pts, key in self.frame_info[ri]:
                selectors[ri].push_frame(si, rank_pts, key)

        # Gamma-selected masks + CC once per range (batched native call).
        wmax, dets_per_range = [], []
        thr = cfg.compressed.mask_threshold
        for ri, (start, count) in enumerate(bounds):
            w = max(0, (count - t) // g + 1) if count >= t else 0
            wmax.append(w)
            if w == 0:
                dets_per_range.append(None)
                continue
            masks = (
                probs[ri][np.arange(w) * g] > thr
            ).astype(np.uint8)
            ltwh, _, valid = cc_boxes(masks, cfg.compressed.cc_threshold, 16)
            dets_per_range.append((ltwh, valid))

        longest_w = max(wmax, default=0)
        n_chunks = -(-longest_w // f) if longest_w > 0 else 0
        for chunk_i in range(n_chunks):
            win0 = chunk_i * f
            for ri, (start, count) in enumerate(bounds):
                if win0 >= wmax[ri]:
                    continue
                sel, hs = selectors[ri], trackers[ri]
                ltwh, valid = dets_per_range[ri]
                for k in range(f):
                    if win0 + k >= wmax[ri]:
                        break
                    frame_idx = (win0 + k) * g + t - 1
                    pts = (start + frame_idx) / fps
                    dets = ltwh[win0 + k][valid[win0 + k]]
                    min_required_frame = hs.update(dets, float(frame_idx))
                    min_required = (
                        None
                        if min_required_frame is None
                        else (start + min_required_frame) / fps
                    )
                    sel.on_mask_frame(pts, min_required)

        for sel, ht in zip(selectors, trackers):
            sel.finish()
            ht.finalize()

        # Pixel stage -> GT-lookup detections (display order per range,
        # droppable dependency frames discarded like _run_pixel_stage).
        self._last_pix_jobs = pix_jobs  # debugging/inspection hook
        dets = []
        n_inference_frames = 0
        for jobs in pix_jobs:
            infer = sorted(
                (fr for fr in jobs if not fr.droppable),
                key=lambda fr: self.sample_sec[fr.sample_index],
            )
            n_inference_frames += len(infer)
            for fr in infer:
                dets.extend(self.gt_by_ts.get(self.sample_sec[fr.sample_index], []))
        if dets:
            agg.update_dnn(dets)
        agg.terminate()

        counts = [s.counts for s in selectors]
        total = sum(c for _, c in bounds)
        dropped = sum(c.dropped for c in counts)
        dep = sum(c.decoded_dependency for c in counts)
        inf = sum(c.decoded_inference for c in counts)

        ds = DATASETS[self.dataset]
        cova_df = load_cova(out_dir)
        res = parse_query(
            self.gt_df,
            cova_df,
            self.duration,
            list(ds.targets),
            exclude=ds.exclude,
            region=ds.region,
            frame_size=ds.frame_size,
            ts_start=ts_start,
            ts_end=ts_end,
        )
        report = {
            "bp_accuracy": round(res.bp_accuracy, 4),
            "gc_error": round(res.gc_error, 4),
            "bp_accuracy_local": round(res.bp_accuracy_local, 4),
            "gc_error_local": round(res.gc_error_local, 4),
            "num_slots": res.num_slots,
            "decode_filter_rate": round(1.0 - (dep + inf) / max(total, 1), 4),
            "inference_filter_rate": round(1.0 - inf / max(total, 1), 4),
            "frames": total,
            "dead_tracks": dead_count[0],
            "inference_frames": n_inference_frames,
            "dropped": dropped,
        }
        for ht in trackers:
            ht.close()
        if tmp is not None:
            tmp.cleanup()
        return report


def make_cfg(
    mask_threshold=0.5,
    cc_threshold=1,
    gamma=1,
    alpha=0,
    beta=0,
    infer_i=True,
    max_age=60,
    min_hits=30,
    iou_threshold=0.1,
    use_nnz=False,
    num_ranges=4,
):
    from cova_tpu_torch.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
        SelectorConfig,
        SortConfig,
    )

    return CovaConfig(
        sort=SortConfig(
            iou_threshold=iou_threshold, max_age=max_age, min_hits=min_hits
        ),
        compressed=CompressedStageConfig(
            gamma=gamma,
            cc_threshold=cc_threshold,
            mask_threshold=mask_threshold,
            use_nnz_channel=use_nnz,
        ),
        selector=SelectorConfig(alpha=alpha, beta=beta, infer_i=infer_i),
        parallel=ParallelConfig(num_ranges=num_ranges),
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=str(REPO / "artifacts" / "blobnet_synth.npz"))
    ap.add_argument("--nnz", action="store_true")
    ap.add_argument("--signed", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--wide", action="store_true",
                    help="grid also spans max_age (tracker family)")
    ap.add_argument("--video", default=str(SYNTH_VIDEO))
    ap.add_argument("--dataset", default="synth",
                    help="query config key (cova_tpu_torch/query/datasets.py)")
    ap.add_argument("--gt", default=str(SYNTH_GT),
                    help="ground-truth detections CSV (naive dnn.csv)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the BlobNet pass (cpu on request)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cap on frames per GoP range")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    # The artifact's stored input contract provides the defaults.
    from cova_tpu_torch.models.blobnet import load_meta_npz

    wmeta = load_meta_npz(args.weights)
    use_nnz = args.nnz or bool(wmeta.get("use_nnz_channel", False))
    signed = args.signed or bool(wmeta.get("signed_mv", False))

    ctx = SweepContext(args.video, gt_csv=args.gt, dataset=args.dataset,
                       max_frames=args.max_frames, device=args.device)
    probs = ctx.probs(args.weights, use_nnz=use_nnz, signed_mv=signed)

    # The dataset's committed operating point.
    point = OPERATING_POINTS.get(args.dataset, {})
    base = ctx.run_config(probs, make_cfg(use_nnz=use_nnz, **point))
    print("defaults:", json.dumps(base))
    golden = REPO / "golden" / args.dataset / "report.json"
    if (point and golden.exists() and not args.max_frames
            and pathlib.Path(args.video).resolve() == SYNTH_VIDEO.resolve()):
        ref = json.loads(golden.read_text())
        keys = ("bp_accuracy", "gc_error", "bp_accuracy_local", "gc_error_local",
                "decode_filter_rate", "inference_filter_rate")
        print(f"committed {golden.relative_to(REPO)} (taken on a TPU through the "
              "full pipeline): " + ", ".join(f"{k} {ref[k]}" for k in keys))

    if args.grid or args.wide:
        rows = []
        ages = [30, 45, 60] if args.wide else [60]
        for mt, cc, mh, ma in itertools.product(
            [0.3, 0.4, 0.5, 0.6, 0.7], [1, 2, 3], [10, 20, 30, 40], ages
        ):
            cfg = make_cfg(
                mask_threshold=mt, cc_threshold=cc, min_hits=mh,
                max_age=ma, use_nnz=use_nnz,
            )
            rep = ctx.run_config(probs, cfg)
            rows.append(((mt, cc, mh, ma), rep))
            print(
                f"mt={mt} cc={cc} mh={mh} ma={ma}: BP={rep['bp_accuracy']:.4f} "
                f"GC={rep['gc_error']:.4f} BPL={rep['bp_accuracy_local']:.4f} "
                f"GCL={rep['gc_error_local']:.4f} "
                f"inf={rep['inference_frames']} dead={rep['dead_tracks']}"
            )
        rows.sort(key=lambda r: (-r[1]["bp_accuracy"], r[1]["gc_error"]))
        print("best:", rows[0])


if __name__ == "__main__":
    main()
