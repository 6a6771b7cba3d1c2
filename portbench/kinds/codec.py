"""The ``codec`` traffic kind: one client in a closed loop. Each request
carries ``clips`` clips from host memory through ``Codec.encode`` ->
``pack_latent`` -> ``unpack_latent`` -> ``Codec.decode`` and ends with the
waveform on the host. A pool of requests made from the seed is cycled. The
answers of ``check_requests`` requests, drawn from the seed among the first
``check_among``, are kept for the check.
"""

from __future__ import annotations

import time

import numpy as np

from .. import check, common, counts, inputs


class Cell:
    unit = "request"

    def __init__(self, torch, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.torch, self.cfg, self.traffic, self.spec, self.seed, self.device = torch, cfg, traffic, spec, seed, device
        self.clips = traffic["clips"]
        self.n = cfg["model"]["num_vertices"]
        self.k = 0
        self.spans: list = []
        self.profiling = False
        rng = np.random.default_rng(inputs.sub_seed(seed, "check_requests"))
        self.kept_ids = set(rng.choice(traffic["check_among"], traffic["check_requests"], replace=False).tolist())
        self.kept: dict = {}
        if spec["compute_dtype"] != "float32":
            raise ValueError("the port's Codec computes in float32: a codec cell's compute_dtype is float32")

    def setup(self) -> None:
        torch, cfg, tr = self.torch, self.cfg, self.traffic
        import topo_audio_autoencoder_torch as port

        samples = cfg["model"]["num_samples"]
        pool = inputs.make_clips(tr["pool_requests"] * self.clips, samples, self.seed, "requests", self.device)
        self.pool = pool.reshape(tr["pool_requests"], self.clips, 1, samples).cpu().numpy()
        del pool
        self.port = port
        model = common.program_model(torch, port, cfg, self.seed, self.device)
        self.codec = port.Codec(model, device=self.device)
        for _ in range(tr["warmup_requests"]):
            self.request(0, keep=False)
        self.k = 0

    def request(self, i: int, keep: bool = True) -> None:
        torch, port = self.torch, self.port
        x = self.pool[i % self.pool.shape[0]]
        t0 = time.perf_counter()
        latent = self.codec.encode(x)
        if self.device != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        packed = port.pack_latent(latent)
        latent = port.unpack_latent(packed, self.n)
        t2 = time.perf_counter()
        wave = self.codec.decode(latent, x.shape[-1]).cpu().numpy()
        t3 = time.perf_counter()
        if not self.profiling and keep:
            self.spans.append((t3 - t0, t1 - t0, t2 - t1, t3 - t2))
        if keep and i in self.kept_ids:
            self.kept[i] = (packed, wave[:, 0])

    def run(self) -> None:
        self.request(self.k)
        self.k += 1

    def window_metrics(self, units: int, window_s: float) -> dict:
        spans = np.asarray(self.spans) * 1e3
        return {self.traffic["rate_metric"]: self.clips * units / window_s,
                self.traffic["tail_metric"]: float(np.percentile(spans[:, 0], 95)),
                "_median_ms": float(np.median(spans[:, 0])), "_requests": len(spans),
                "_mean_ms_encode_pack_decode": spans[:, 1:].mean(axis=0).tolist()}

    def after_window(self) -> None:
        """Serve, unmeasured, the kept requests that the window did not
        reach."""
        while self.k <= max(self.kept_ids):
            self.run()

    def release(self) -> None:
        del self.codec
        common.free(self.torch)

    def answers(self) -> tuple:
        """The kept requests' inputs, wire bits and waveforms, in order."""
        ids = sorted(self.kept)
        total = sum(common.rank_sizes(self.n))
        bits = np.concatenate([np.unpackbits(self.kept[i][0], axis=-1, count=total).astype(bool) for i in ids])
        clips = np.concatenate([self.pool[i % self.pool.shape[0]] for i in ids])
        waves = np.concatenate([self.kept[i][1] for i in ids])
        return clips, bits, waves

    def reference_readings(self, control: bool = False) -> dict:
        """The reference, in the cell's compute precision with TF32 off:
        its own bits for the kept inputs, its decode of them, and its decode
        of the program's bits. With ``control``, the reference in the cell's
        ``control`` precision takes the program's place: its bits and its
        decode of them are judged."""
        from ..reference import codec as ref_codec

        torch = self.torch
        clips, bits, waves = self.answers()
        block, samples = self.traffic["check_blocks"], clips.shape[-1]
        with common.no_tf32(torch):
            model, dtype = self.reference_in(self.spec["compute_dtype"])
            x = torch.as_tensor(clips, device=self.device)
            out = {"ref_bits": ref_codec.encode_bits(model, x.to(dtype), block)}
            out["ref_own_waves"] = ref_codec.decode_bits(model, out["ref_bits"], samples, self.device, dtype, block)
            if control:
                low, low_dtype = self.reference_in(self.spec["control"])
                bits = ref_codec.encode_bits(low, x.to(low_dtype), block)
                waves = ref_codec.decode_bits(low, bits, samples, self.device, low_dtype, block)
                del low
            out["prog_bits"], out["prog_waves"] = bits, waves
            out["ref_waves"] = ref_codec.decode_bits(model, bits, samples, self.device, dtype, block)
        out["tables"] = model.tables
        del model
        common.free(torch)
        return out

    def reference_in(self, name: str) -> tuple:
        """The plain model with its parameters cast into precision
        ``name`` and its other floats in the dtype that cast ends in; that
        dtype."""
        torch = self.torch
        model = common.reference_model(torch, self.cfg, self.seed, self.device)
        cast = common.precision(torch, name)
        if cast is None:
            return model, torch.float32
        with torch.no_grad():
            for p in model.parameters():
                p.data = cast(p.data)
        return model.to(torch.bfloat16), torch.bfloat16

    def numbers(self, ref: dict) -> dict:
        flips = check.root_flips(ref["prog_bits"], ref["ref_bits"], ref["tables"])
        gaps = check.wave_gap(ref["prog_waves"], ref["ref_waves"])
        agree = (ref["prog_bits"] == ref["ref_bits"]).all(axis=1)
        own = check.wave_gap(ref["prog_waves"][agree], ref["ref_own_waves"][agree])
        self.density = common.active_rows(ref["prog_bits"], ref["tables"].sizes,
                                          self.cfg["model"].get("pack_capacities"))
        return {"root_flips_per_clip": (float(flips.mean()), int(flips.max())),
                "wave_gap": (float(gaps.max()), int(gaps.argmax())),
                "wave_gap_own_bits": (float(own.max()) if own.size else float("nan"), int(agree.sum()))}

    def flops_per_unit(self) -> float:
        sizes = common.rank_sizes(self.n)
        return counts.codec_request_flops(self.cfg, sizes, self.clips, self.density["rows"],
                                          common.pqmf_taps(self.cfg))

    def attention_counts(self) -> dict:
        m = self.cfg["model"]
        q = m["num_samples"] // m["num_bands"] // 16
        active = self.clips * sum(self.density["rows"][1:])
        keys = self.clips * sum(self.density["keys"][1:])
        elt = common.element_bytes(self.spec["compute_dtype"])
        return {"fwd": counts.attention_fwd_counts(q, m["sccn_hidden_dim"], counts.ATTENTION_HEADS, active, keys,
                                                   self.clips, elt)}
