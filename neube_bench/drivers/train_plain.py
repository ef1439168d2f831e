"""GAN training with no geometry through the training CLI's own loop: a
plain StyleGAN2 configuration (no encoder, no geometry data, no Ggeom),
driven as ``drivers/train.py`` drives NeuBE's training.

It is ``drivers/train.py:Cell`` with the geometry taken out: set-up writes
only the traffic's seeded style images (``style_chunk`` images made at a
time on the device) as the zip ``--data`` reads and makes the weights of G
and D from the seed (``configf_weights.py``); the check matches the
delivered style rows alone and runs the plain reference of the
configuration (``reference/train_configf.py``).  The window, the traced
period, the phases' draws, the controls and the faults are the parent's,
and so are the check's numbers; beside them each checked step is taken
again by the reference from the program's own state before it
(``reference/train_configf.py:step_numbers``), and the traffic's limits
hold Dmain's loss and the change of G and D step by step there, where
config-f's learning rate parts the two trajectories too far to compare
them after three batches.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from neube_bench import configf_weights as CW
from neube_bench.drivers import train as T
from neube_bench.drivers.stylize import _Phases
from neube_bench.reference import train as RT
from neube_bench.reference import train_configf as RC
from neube_bench.traffic.train_data import style_images, write_zip



class Cell(T.Cell):
    """One training cell of a configuration without geometry."""

    def setup(self):
        cfg, t, dev = self.cfg, self.traffic, self.device
        clock = _Phases(self)
        os.makedirs(T.BUILD, exist_ok=True)
        self.work = tempfile.mkdtemp(prefix="bench_train_plain_",
                                     dir=T.BUILD)
        self.styles = style_images(t["styles"], cfg["img_resolution"],
                                   self.seed, t["style"], dev,
                                   chunk=t["style_chunk"])
        style_zip = os.path.join(self.work, "styles.zip")
        write_zip(style_zip, self.styles)
        clock("data")
        self.trees = CW.make_training_trees(cfg, self.seed, dev)
        self.draws = self._make_draws()
        clock("weights and draws")
        # As drivers/train.py: TensorBoard's own stub of TensorFlow, so that
        # no TensorFlow (and no JAX behind it) is loaded.
        if "tensorflow" not in sys.modules:
            sys.modules["tensorflow"] = None
        from brushstroke_engine_torch.ops.precision import set_precision_mode
        from brushstroke_engine_torch.tools import train as cli
        set_precision_mode(cfg["precision"])
        argv = list(cfg["flags"]) + [
            "--outdir", os.path.join(self.work, "runs"), "--data", style_zip,
            "--seed", str(self.seed % 2 ** 31), "--device", dev.type]
        self.loop, _ = cli.build(argv)
        self._place()
        self._instrument()
        clock("build")
        try:
            self._run_to(self.start + self.n_check)
        except BaseException:
            self.free_program()     # the steps module as it was
            raise
        clock("warm-up batches")

    def _instrument(self):
        """The parent's hooks, with the fed rows kept as style rows
        alone."""
        loop = self.loop
        fetch = loop._fetch_batch
        super()._instrument()

        def fetch_batch():
            out = fetch()
            k = loop.batch_idx - self.start
            if self._mode == "check" and 0 <= k < self.n_check:
                self.fed[k] = np.rint((out[0] + 1.0) * 127.5).astype(
                    np.uint8)
            return out

        loop._fetch_batch = fetch_batch

    def _reference_batches(self):
        """The checked batches as the reference takes them, from the
        benchmark's own images: (batches, rows the data chain delivered
        that match none of them)."""
        style_at = {T._digest(a): i for i, a in enumerate(self.styles)}
        unmatched, batches = 0, []
        for k in range(self.n_check):
            if k not in self.fed:
                return None, self.batch * self.n_check
            rows = []
            for s in self.fed[k]:
                i = style_at.get(T._digest(s))
                unmatched += i is None
                rows.append(self.styles[i] if i is not None else s)
            real = torch.from_numpy(np.stack(rows)).to(self.device).float() \
                / 127.5 - 1.0
            batches.append({"real": real, **self.draws[k]})
        return batches, unmatched

    def _follow(self, batches, kind: str = None):
        knobs = dict(T.CONTROLS.get(kind, {}))
        prec = RT.precision(self.cfg, knobs.pop("prec", "reference"))
        share = knobs.pop("pl_rows_share", None)
        if share:
            knobs["pl_rows"] = int(self.batch // self.cfg["pl_batch_shrink"]
                                   * share)
        torch.backends.cuda.matmul.allow_tf32 = prec["tf32"]
        torch.backends.cudnn.allow_tf32 = prec["tf32"]
        try:
            return RC.follow(self.cfg, self.trees, batches, self.start,
                             float(self.traffic["ada_p"]),
                             RT.Knobs(prec, **knobs))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _program_readings(self):
        """The parent's readings, and under ``steps`` each checked step in
        the reference's form (``reference/train_configf.py:follow``'s)."""
        out = super()._program_readings()
        if out is None:
            return None
        like = {"g": self.trees["gen_params"], "d": self.trees["disc_params"]}
        names = {n: set(RT._leaves(t)) for n, t in like.items()}

        def flat(tree, net):
            return {k: v for k, v in T._flat(tree).items() if k in names[net]}

        def opt(o, net):
            return {"count": o["count"], "mu": flat(o["mu"], net),
                    "nu": flat(o["nu"], net)}

        def ref(st):
            return {"like": like, "g": flat(st["g_params"], "g"),
                    "d": flat(st["d_params"], "d"),
                    "g_opt": opt(st["g_opt"], "g"),
                    "d_opt": opt(st["d_opt"], "d"),
                    **{k: st[k] for k in ("w_avg", "pl_mean", "ada_p",
                                          "ada_signs", "ada_count")}}
        out["steps"] = [(k, ph, ref(old), ref(new),
                         float(stats[T.LOSS_STAT[ph]]))
                        for k, ph, old, new, stats in self.records
                        if ph in RT.PHASES]
        return out

    def check(self):
        """``drivers/train.py:Cell.check``'s numbers, and beside them those
        of each checked step taken again by the reference from the state
        the program (or the control) took it from."""
        limits = self.traffic["limits"]
        if getattr(self, "_want", None) is None:
            self._batches, self._unmatched = self._reference_batches()
            self._want = None if self._batches is None \
                else self._follow(self._batches)
        batches, want = self._batches, self._want
        got = None
        if batches is not None:
            got = self._follow(batches, self.impl.split(":", 1)[1]) \
                if self.impl.startswith("control:") \
                else self._program_readings()
        if got is None:
            return {k: float("inf") for k in limits}
        numbers = RT.compare(got, want)
        numbers["feed_rows_unmatched"] = float(self._unmatched)
        numbers.update(RC.step_numbers(self.cfg, batches, got["steps"],
                                       RT.Knobs(RT.precision(self.cfg))))
        leaves = {ph: RT.leaf_table(got["grad"][ph], want["grad"][ph])
                  for ph in RT.PHASES if ph in got["grad"]}
        leaves.update({f"change.{n}": RT.leaf_table(got["change"][n],
                                                    want["change"][n])
                       for n in ("G", "D")})
        images = {**RT.image_gaps(got["aug"], want["aug"]),
                  **RT.image_gaps(got["img"], want["img"])}
        self.diagnostics = {**numbers, "images": images, "leaves": leaves}
        return {k: numbers[k] for k in limits}
