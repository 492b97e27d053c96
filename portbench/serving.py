"""What the serving kinds share: the deployed classifier and its check.

Set-up exports the model with the run's weights as the port's serving
artifact (``scae_tpu_torch.serve.export_serving(...,
polymorphic_batch=True)``, into a directory under ``TMPDIR``), loads it
with ``load_serving`` and warms every batch size the traffic sends (each
call at a new size captures its CUDA graph). The live model is dropped
before the window. A request is one call of the loaded ``ServingModel``
on host float32 images, and ends when its outputs are on the host.

The check takes the outputs of a sample of the window's requests, drawn
from the seed (each kind's ``keep`` says how), and holds them to the
reference's deterministic forward on the same images
(``compare.serve``).
"""

import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import compare, data as data_lib, trace as trace_lib, weights
from portbench.reference import math_mode
from portbench.reference.model import Model

POOL = 4096          # host images the requests take their slices from


class ServeJob:
    """Subclasses define ``sizes`` (the batch sizes sent), ``window`` and
    ``keep`` (which served requests the check takes)."""

    sizes = ()

    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.sample = {}       # request index -> (offset, size, outputs)
        self.sampling = True   # off after the window

    def setup(self):
        from scae_tpu_torch import factory, serve

        run, dev = self.run, self.run.device
        with run.phase("model"):
            model = factory.make_scae(self.cfg["model"], device=dev)
            model.load_state_dict(weights.draw_for(self.cfg["model"],
                                                   run.seed, dev))
        self.tmp = tempfile.mkdtemp(prefix="portbench-serve-")
        with run.phase("export"):
            serve.export_serving(model, image_shape=self.cfg["model"][
                "image_shape"], batch_size=None, out_dir=self.tmp,
                polymorphic_batch=True, device=dev,
                model_config=self.cfg["model"])
        del model
        with run.phase("load"):
            self.model = serve.load_serving(self.tmp, device=dev)
        if run.fault is not None:
            run.fault(self)
        with run.phase("data"):
            self.pool = data_lib.serving_pool(
                POOL, self.cfg["data"], self.cfg["model"]["image_shape"],
                run.seed)
        with run.phase("captures"):
            for size in self.sizes:
                self.call(0, size)

    def call(self, offset, size, traced=False):
        """One request: the images at ``offset`` of the pool, outputs on
        the host. Returns them."""
        images = self.pool[offset:offset + size]
        with trace_lib.span(torch, f"request.{size}", traced):
            out = self.model(images)
            return {k: v.cpu() for k, v in out.items()}

    def serve_one(self, i, offset, size, traced=False):
        """Request ``i``: (start, end) on the host clock; offers its
        outputs to the sample while the window runs."""
        start = time.perf_counter()
        out = self.call(offset, size, traced)
        end = time.perf_counter()
        if self.sampling:
            self.keep(i, offset, size, out)
        return start, end

    def release(self):
        self.model = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, offset, size, model):
        images = self.pool[offset:offset + size].to(self.run.device)
        with torch.no_grad():
            out = model.serve(images)
        return {k: v.cpu() for k, v in out.items()}

    def check(self):
        model = Model(self.cfg["model"]).to(self.run.device)
        model.load_state_dict(weights.draw_for(self.cfg["model"],
                                               self.run.seed,
                                               self.run.device))
        pairs = []
        with math_mode():
            for i in sorted(self.sample):
                offset, size, out = self.sample[i]
                pairs.append((out, self.reference_outputs(offset, size,
                                                          model)))
        if not pairs:
            return [("sampled_requests", 0.0, -1.0)]
        return compare.serve(pairs, self.run.limits)
