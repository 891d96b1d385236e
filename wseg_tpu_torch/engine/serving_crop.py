"""Batched multi-crop inference server (``TEST.METHOD: multicrop``).

Mirror of ``wseg_tpu/engine/serving_crop.py``.  The reference's multicrop
mode tiles the image, centred in PAD_SIZE, with a grid of CROP_SIZE
crops (the flipped variant first when FLIP is on) and reassembles the
crop masks with per-pixel overlap counts; unlike the multi-scale merge
it applies no BG_POW.  Every crop has one shape and the grid depends
only on the configuration, so a group's whole pipeline is one step:

  uint8 padded canvases (B, PH, PW, 3)
    -> normalise + zero outside each image's window
    -> slice the G grid crops (+ the flipped variants)
    -> one forward over the image-major (B*G) crop batch
    -> unflip + add each crop's masks back onto its canvas
    -> times G / the overlap counts

The merged maps feed the same postprocess as the multi-scale server
(which divides by n_views = G).  ``MultiCropServer`` reuses
``MultiScaleServer``'s queue, grouping, finisher and postprocess
machinery.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from wseg_tpu_torch.data.multiscale import CropViews
from wseg_tpu_torch.engine.infer import normalise_in_window
from wseg_tpu_torch.engine.serving import MultiScaleServer


def make_crop_infer_fn(model):
    """fn(canv_u8 (B, PH, PW, 3), owin (B, 4), *, coords, crop_hw, flip)
    -> (cls (B*G, C-1) image-major, merged (B, PH, PW, C)).

    ``merged`` is sum / counts * G, so the postprocess's division by
    n_views = G gives the reference's count-normalised mean; canvas
    pixels no crop covers (none, for a grid ``data.multiscale.
    grid_coords`` accepts) would count 1."""
    @torch.inference_mode()
    def infer_crops(canv_u8, owin, *, coords, crop_hw, flip):
        b, ph, pw, _ = canv_u8.shape
        ch, cw = crop_hw
        with record_function("serve.views"):
            x = normalise_in_window(canv_u8, owin)
            crops = []
            for s_h, s_w in coords:
                c = x[:, s_h:s_h + ch, s_w:s_w + cw]
                if flip:  # the flipped variant first (reference CropLoader)
                    crops.append(c.flip(2))
                crops.append(c)
            g = len(crops)
            # image-major: slot i's G views are rows [i*G, (i+1)*G), as
            # the postprocess's cls reshape (dispatch_group_cls) reads them
            xb = torch.stack(crops, dim=1).reshape(b * g, ch, cw, 3)
        with record_function("serve.forward"):
            out = model(xb)
        with record_function("serve.merge"):
            masks = out.masks.float()
            nc = masks.shape[-1]
            m = masks.reshape(b, g, ch, cw, nc)
            total = torch.zeros((b, ph, pw, nc), dtype=torch.float32,
                                device=canv_u8.device)
            counts = np.zeros((ph, pw), np.float32)
            vi = 0
            for s_h, s_w in coords:
                for f in ([True, False] if flip else [False]):
                    mg = m[:, vi].flip(2) if f else m[:, vi]
                    total[:, s_h:s_h + ch, s_w:s_w + cw] += mg
                    counts[s_h:s_h + ch, s_w:s_w + cw] += 1.0
                    vi += 1
            scale = torch.from_numpy(
                np.float32(g) / np.maximum(counts, 1.0)).to(total.device)
            merged = total * scale[None, :, :, None]
        return out.cls, merged

    return infer_crops


class MultiCropServer(MultiScaleServer):
    """``MultiScaleServer`` for ``TEST.METHOD: multicrop``: every image
    shares one signature (the padded canvas), so groups never fragment
    and one step serves every image size."""

    def _init_paths(self, model, test_cfg):
        self.views = CropViews(test_cfg.CROP_SIZE, test_cfg.CROP_GRID_SIZE,
                               test_cfg.PAD_SIZE, bool(test_cfg.FLIP))
        self.device_views = False
        # postprocess cls rows per slot: the grid's views
        self._cls_vpi = self.views.num_views
        self.infer_crops = make_crop_infer_fn(model)

    def _group_sig(self, image_u8):
        return None  # one static canvas: every image fits every group

    def dispatch_crops(self, canv_d, owin_d):
        return self.infer_crops(
            canv_d, owin_d, coords=self.views.coords,
            crop_hw=(self.views.crop_h, self.views.crop_w),
            flip=self.views.flip)

    # ---------------------------------------------------------- worker
    @torch.inference_mode()
    def _process(self, group):
        n, (ph, pw) = len(group), self.views.pad_size
        with record_function("serve.upload"):
            canv = np.zeros((n, ph, pw, 3), np.uint8)
            owin = np.zeros((n, 4), np.int32)
            sizes = []
            for gi, (image, _, _) in enumerate(group):
                h, w = image.shape[:2]
                pt, pl, _, _ = self.views.window(h, w)
                canv[gi, pt:pt + h, pl:pl + w] = image[..., :3]
                owin[gi] = (pt, pl, h, w)
                sizes.append((h, w))
            canv_d = torch.from_numpy(canv).to(self.device)
            owin_d = torch.from_numpy(owin).to(self.device)
        cls, merged = self.dispatch_crops(canv_d, owin_d)
        if self.postprocess is not None:
            self._postprocess_rows(group, owin, sizes, merged, canv_d, [cls])
            return

        # no postprocess: the reference's MergeCrops maths on the host
        # (labels applied after the count normalisation, no BG_POW)
        g = self.views.num_views

        def finish():
            mg = merged.cpu().numpy()
            cls_np = cls.float().cpu().numpy()
            for gi, (_, gt_labels, fut) in enumerate(group):
                pt, pl, h, w = owin[gi]
                labels = self._labels(list(cls_np[gi * g:(gi + 1) * g]),
                                      gt_labels)
                m = mg[gi, pt:pt + h, pl:pl + w] / float(g)
                m[..., 1:] *= labels[None, None, :]
                fut.set_result((m, labels))

        self._submit_finish(group, finish)
