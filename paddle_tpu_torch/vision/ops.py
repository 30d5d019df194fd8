"""``paddle.vision.ops``: detection ops (counterpart of
``paddle_tpu/vision/ops.py``), in plain PyTorch (no torchvision).

The reference's rules are kept: ``roi_align`` takes ``sampling_ratio``
samples a bin edge, or 2 when it is not positive (the reference's static
stand-in for the adaptive count), and zeroes samples outside ``[-1, H]``
by ``[-1, W]``; ``roi_pool`` max-pools 2 x 2 samples a cell;
``psroi_pool`` reads output cell ``(i, j)`` from channel group ``(i,
j)`` of a ``roi_align``; ``deform_conv2d`` samples bilinearly at the
shifted taps (clamped to the padded input) and contracts with the
weight, with one deformable group and one group (a group count above 1
raises: the reference's contraction fails there); ``nms`` is greedy in
score order, within each category when ``category_idxs`` is given.
``nms``'s suppression loop, ``distribute_fpn_proposals`` and
``matrix_nms`` run on the host, the last two in numpy as in the
reference; indices come back as int64 Tensors. ``yolo_loss`` and
``generate_proposals`` raise ``NotImplementedError`` as the reference's
do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer


def _on_place(a):
    from ..device import _current_device

    return Tensor._wrap(torch.as_tensor(a).to(_current_device()))


def box_area(boxes):
    return apply_op(lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]),
                    boxes, _op_name="box_area")


def _iou(a, b):
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def box_iou(boxes1, boxes2):
    return apply_op(_iou, boxes1, boxes2, _op_name="box_iou")


def _greedy_nms(bx, sc, iou_threshold):
    """Indices kept, in descending score order (ties by index)."""
    n = bx.shape[0]
    if sc is None:
        sc = torch.arange(n, 0, -1, dtype=torch.float32, device=bx.device)
    order = torch.argsort(-sc, stable=True)
    over = (_iou(bx[order], bx[order]) > iou_threshold).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return order[torch.as_tensor(keep, device=bx.device)]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS: kept indices sorted by score; with ``category_idxs``,
    suppression happens within each category only."""
    bx = boxes._data
    sc = None if scores is None else scores._data
    if category_idxs is None:
        kept = _greedy_nms(bx, sc, iou_threshold)
    else:
        cats = (category_idxs._data if isinstance(category_idxs, Tensor)
                else torch.as_tensor(np.asarray(category_idxs)))
        cats = cats.to(bx.device)
        if categories is None:
            categories = torch.unique(cats).tolist()
        parts = []
        for c in categories:
            idx = torch.nonzero(cats == int(c)).reshape(-1)
            if idx.numel():
                parts.append(idx[_greedy_nms(
                    bx[idx], None if sc is None else sc[idx],
                    iou_threshold)])
        kept = (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.int64, device=bx.device))
        if sc is not None:
            kept = kept[torch.argsort(-sc[kept], stable=True)]
    if top_k is not None:
        kept = kept[:top_k]
    return Tensor._wrap(kept)


def _box_batch(bx, bn):
    return torch.repeat_interleave(
        torch.arange(bn.shape[0], device=bx.device), bn.long(),
        output_size=bx.shape[0])


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    grid = sampling_ratio if sampling_ratio > 0 else 2

    def _ra(feat, bx, bn):
        h, w = feat.shape[2], feat.shape[3]
        bi = _box_batch(bx, bn)
        offset = 0.5 if aligned else 0.0
        x1, y1, x2, y2 = (bx[:, i] * spatial_scale - offset for i in range(4))
        floor = 1e-4 if aligned else 1.0
        bw = (x2 - x1).clamp(min=floor)
        bh = (y2 - y1).clamp(min=floor)
        sub = (torch.arange(grid, device=bx.device, dtype=bx.dtype)
               + 0.5) / grid
        # [K, oh, g] and [K, ow, g] sample centers
        ys = y1[:, None, None] + (
            torch.arange(oh, device=bx.device, dtype=bx.dtype)[None, :, None]
            + sub[None, None, :]) * (bh / oh)[:, None, None]
        xs = x1[:, None, None] + (
            torch.arange(ow, device=bx.device, dtype=bx.dtype)[None, :, None]
            + sub[None, None, :]) * (bw / ow)[:, None, None]
        yy = ys[:, :, :, None, None].expand(-1, oh, grid, ow, grid)
        xx = xs[:, None, None, :, :].expand(-1, oh, grid, ow, grid)
        valid = (yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)
        yc = yy.clamp(0.0, h - 1)
        xc = xx.clamp(0.0, w - 1)
        y0 = yc.floor().long()
        x0 = xc.floor().long()
        y1i = (y0 + 1).clamp(max=h - 1)
        x1i = (x0 + 1).clamp(max=w - 1)
        wy = (yc - y0)[..., None]
        wx = (xc - x0)[..., None]
        b = bi[:, None, None, None, None]
        # [K, oh, g, ow, g, C]
        val = (feat[b, :, y0, x0] * (1 - wy) * (1 - wx)
               + feat[b, :, y0, x1i] * (1 - wy) * wx
               + feat[b, :, y1i, x0] * wy * (1 - wx)
               + feat[b, :, y1i, x1i] * wy * wx)
        val = torch.where(valid[..., None], val, torch.zeros_like(val))
        return val.mean(dim=(2, 4)).permute(0, 3, 1, 2)

    return apply_op(_ra, x, boxes, boxes_num, _op_name="roi_align")


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))

    def _rp(feat, bx, bn):
        c, h, w = feat.shape[1], feat.shape[2], feat.shape[3]
        bi = _box_batch(bx, bn)
        x1 = torch.floor(bx[:, 0] * spatial_scale).long()
        y1 = torch.floor(bx[:, 1] * spatial_scale).long()
        x2 = torch.ceil(bx[:, 2] * spatial_scale).long()
        y2 = torch.ceil(bx[:, 3] * spatial_scale).long()
        bh = (y2 - y1).clamp(min=1)
        bw = (x2 - x1).clamp(min=1)
        # 2 x 2 samples a cell (the reference's int32 truncation of the
        # float positions), max-pooled
        ry = torch.arange(oh * 2, device=bx.device)
        rx = torch.arange(ow * 2, device=bx.device)
        gy = (y1[:, None] + (ry[None, :] * bh[:, None] / (oh * 2)).to(
            torch.int32)).clamp(0, h - 1)
        gx = (x1[:, None] + (rx[None, :] * bw[:, None] / (ow * 2)).to(
            torch.int32)).clamp(0, w - 1)
        fm = feat[bi[:, None, None], :, gy[:, :, None].long(),
                  gx[:, None, :].long()]          # [K, 2oh, 2ow, C]
        fm = fm.reshape(-1, oh, 2, ow, 2, c)
        return fm.amax(dim=(2, 4)).permute(0, 3, 1, 2)

    return apply_op(_rp, x, boxes, boxes_num, _op_name="roi_pool")


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling: channel group (i, j) feeds output
    cell (i, j)."""
    k = output_size if isinstance(output_size, int) else output_size[0]
    pooled = roi_align(x, boxes, boxes_num, k, spatial_scale)

    def _ps(p):
        nb, c, oh, ow = p.shape
        p = p.reshape(nb, c // (oh * ow), oh, ow, oh, ow)
        ii = torch.arange(oh, device=p.device)[:, None]
        jj = torch.arange(ow, device=p.device)[None, :]
        return p[:, :, ii, jj, ii, jj]

    return apply_op(_ps, pooled, _op_name="psroi_pool")


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    def _yb(feat, sizes):
        n, _, h, w = feat.shape
        na = len(anchors) // 2
        anc = torch.tensor(anchors, dtype=torch.float32,
                           device=feat.device).reshape(na, 2)
        feat = feat.reshape(n, na, 5 + class_num, h, w)
        gx = torch.arange(w, device=feat.device)[None, None, None, :]
        gy = torch.arange(h, device=feat.device)[None, None, :, None]
        bx = (torch.sigmoid(feat[:, :, 0]) * scale_x_y
              - (scale_x_y - 1) / 2 + gx) / w
        by = (torch.sigmoid(feat[:, :, 1]) * scale_x_y
              - (scale_x_y - 1) / 2 + gy) / h
        bw = torch.exp(feat[:, :, 2]) * anc[None, :, 0, None, None] / (
            w * downsample_ratio)
        bh = torch.exp(feat[:, :, 3]) * anc[None, :, 1, None, None] / (
            h * downsample_ratio)
        conf = torch.sigmoid(feat[:, :, 4])
        probs = torch.sigmoid(feat[:, :, 5:]) * conf[:, :, None]
        img_h = sizes[:, 0].float()[:, None, None, None]
        img_w = sizes[:, 1].float()[:, None, None, None]
        x1 = (bx - bw / 2) * img_w
        y1 = (by - bh / 2) * img_h
        x2 = (bx + bw / 2) * img_w
        y2 = (by + bh / 2) * img_h
        if clip_bbox:
            x1 = torch.minimum(x1.clamp(min=0), img_w - 1)
            y1 = torch.minimum(y1.clamp(min=0), img_h - 1)
            x2 = torch.minimum(x2.clamp(min=0), img_w - 1)
            y2 = torch.minimum(y2.clamp(min=0), img_h - 1)
        boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
        scores = probs.movedim(2, -1).reshape(n, -1, class_num)
        keep = (conf.reshape(n, -1) > conf_thresh)[..., None]
        return boxes * keep, scores * keep

    return apply_op(_yb, x, img_size, _op_name="yolo_box")


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable conv v1 (v2 with ``mask``): bilinear samples at the
    offset taps, contracted with the weight."""
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    pd = (padding, padding) if isinstance(padding, int) else tuple(padding)
    dl = (dilation, dilation) if isinstance(dilation, int) else tuple(
        dilation)
    if deformable_groups != 1:
        raise NotImplementedError("deformable_groups > 1")
    if groups != 1:
        raise NotImplementedError(
            "deform_conv2d with groups > 1: the reference's contraction "
            "takes one group")

    def _dc(xa, off, w, b, m):
        n, _, h, win = xa.shape
        kh, kw = w.shape[2], w.shape[3]
        oh = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
        ow = (win + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
        xp = torch.nn.functional.pad(xa, (pd[1], pd[1], pd[0], pd[0]))
        hp, wp = xp.shape[2], xp.shape[3]
        dev = xa.device
        base_y = (torch.arange(oh, device=dev)[:, None, None, None] * st[0]
                  + torch.arange(kh, device=dev)[None, None, :, None] * dl[0])
        base_x = (torch.arange(ow, device=dev)[None, :, None, None] * st[1]
                  + torch.arange(kw, device=dev)[None, None, None, :] * dl[1])
        # offsets [N, kh*kw*2, oh, ow] hold (dy, dx) pairs per tap
        offr = off.reshape(n, kh, kw, 2, oh, ow)
        dy = offr[:, :, :, 0].permute(0, 3, 4, 1, 2)      # [N,oh,ow,kh,kw]
        dx = offr[:, :, :, 1].permute(0, 3, 4, 1, 2)
        sy = base_y[None] + dy
        sx = base_x[None] + dx
        y0 = sy.floor().clamp(0, hp - 1).long()
        x0 = sx.floor().clamp(0, wp - 1).long()
        y1 = (y0 + 1).clamp(max=hp - 1)
        x1 = (x0 + 1).clamp(max=wp - 1)
        wy = (sy.clamp(0, hp - 1) - y0)[..., None]
        wx = (sx.clamp(0, wp - 1) - x0)[..., None]
        bi = torch.arange(n, device=dev)[:, None, None, None, None]
        # [N, oh, ow, kh, kw, C]
        val = (xp[bi, :, y0, x0] * (1 - wy) * (1 - wx)
               + xp[bi, :, y0, x1] * (1 - wy) * wx
               + xp[bi, :, y1, x0] * wy * (1 - wx)
               + xp[bi, :, y1, x1] * wy * wx)
        if m is not None:
            val = val * m.reshape(n, kh, kw, oh, ow).permute(
                0, 3, 4, 1, 2)[..., None]
        out = torch.einsum("nijklc,ockl->noij", val, w)
        if b is not None:
            out = out + b[None, :, None, None]
        return out

    return apply_op(_dc, x, offset, weight, bias, mask,
                    _op_name="deform_conv2d")


class DeformConv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else kernel_size)
        self.args = (stride, padding, dilation, deformable_groups, groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, ks[0], ks[1]])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([out_channels], is_bias=True))

    def forward(self, x, offset, mask=None):
        st, pd, dl, dg, g = self.args
        return deform_conv2d(x, offset, self.weight, self.bias, st, pd, dl,
                             dg, g, mask)


def _host(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    rois = _host(fpn_rois)
    scale = np.sqrt(np.maximum(
        (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]), 1e-6))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    outs, index = [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        outs.append(_on_place(rois[idx]))
        index.append(idx)
    restore = (np.argsort(np.concatenate(index)) if index
               else np.array([], np.int64))
    return (outs,
            [_on_place(np.asarray([len(i)], np.int32)) for i in index],
            _on_place(restore.astype(np.int32)))


def yolo_loss(*args, **kwargs):
    raise NotImplementedError(
        "yolo_loss: compose from yolo_box and the standard losses (the "
        "reference does not compute it either)")


def generate_proposals(*args, **kwargs):
    raise NotImplementedError(
        "generate_proposals: compose box decoding and nms (the reference "
        "does not compute it either)")


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes over the (H, W, priors) grid of the feature map."""
    min_sizes = [float(s) for s in (min_sizes if isinstance(
        min_sizes, (list, tuple)) else [min_sizes])]
    if max_sizes is None:
        max_sizes = []
    elif not isinstance(max_sizes, (list, tuple)):
        max_sizes = [float(max_sizes)]
    else:
        max_sizes = [float(s) for s in max_sizes]
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError("max_sizes must match min_sizes length")
    ars = [float(a) for a in (aspect_ratios if isinstance(
        aspect_ratios, (list, tuple)) else [aspect_ratios])]
    out_ars = [1.0]
    for ar in ars:
        if all(abs(ar - e) > 1e-6 for e in out_ars):
            out_ars.append(ar)
            if flip:
                out_ars.append(1.0 / ar)
    var = [float(v) for v in (variance if isinstance(
        variance, (list, tuple)) else [variance] * 4)]

    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_w = float(steps[0]) or iw / fw
    step_h = float(steps[1]) or ih / fh
    whs = []
    for mi, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                whs.append((math.sqrt(ms * max_sizes[mi]),) * 2)
            for ar in out_ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        else:
            for ar in out_ars:
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                whs.append((math.sqrt(ms * max_sizes[mi]),) * 2)
    wh = np.asarray(whs, np.float32)
    cx = (np.arange(fw, dtype=np.float32) + offset) * step_w
    cy = (np.arange(fh, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    c = np.stack([cxg, cyg], -1)[:, :, None, :]
    half = wh[None, None, :, :] / 2.0
    scale = np.asarray([iw, ih], np.float32)
    boxes = np.concatenate([(c - half) / scale, (c + half) / scale], -1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    variances = np.broadcast_to(np.asarray(var, np.float32), boxes.shape)
    return (_on_place(boxes.astype(np.float32)),
            _on_place(np.ascontiguousarray(variances)))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode or decode detection boxes against priors."""
    def _coder(pb, pbv, tb):
        norm = 0.0 if box_normalized else 1.0
        pw = pb[:, 2] - pb[:, 0] + norm
        ph = pb[:, 3] - pb[:, 1] + norm
        pcx = pb[:, 0] + pw / 2.0
        pcy = pb[:, 1] + ph / 2.0
        if pbv is None:
            vx = vy = vw = vh = 1.0
        elif pbv.dim() == 1:
            vx, vy, vw, vh = pbv[0], pbv[1], pbv[2], pbv[3]
        else:
            vx, vy, vw, vh = pbv[:, 0], pbv[:, 1], pbv[:, 2], pbv[:, 3]
        if code_type == "encode_center_size":
            tw = tb[:, 2] - tb[:, 0] + norm
            th = tb[:, 3] - tb[:, 1] + norm
            tcx = tb[:, 0] + tw / 2.0
            tcy = tb[:, 1] + th / 2.0
            # [T, P, 4]: every target against every prior
            ox = ((tcx[:, None] - pcx[None, :]) / pw[None, :]) / vx
            oy = ((tcy[:, None] - pcy[None, :]) / ph[None, :]) / vy
            ow = torch.log(tw[:, None] / pw[None, :]) / vw
            oh = torch.log(th[:, None] / ph[None, :]) / vh
            return torch.stack([ox, oy, ow, oh], -1)
        t = tb[:, None, :] if tb.dim() == 2 else tb
        pw_, ph_, pcx_, pcy_ = (v[:, None] if axis == 0 else v[None, :]
                                for v in (pw, ph, pcx, pcy))
        if pbv is not None and pbv.dim() == 2:
            vx, vy, vw, vh = (v[:, None] if axis == 0 else v[None, :]
                              for v in (vx, vy, vw, vh))
        dcx = vx * t[..., 0] * pw_ + pcx_
        dcy = vy * t[..., 1] * ph_ + pcy_
        dw = torch.exp(vw * t[..., 2]) * pw_
        dh = torch.exp(vh * t[..., 3]) * ph_
        out = torch.stack([dcx - dw / 2.0, dcy - dh / 2.0,
                           dcx + dw / 2.0 - norm, dcy + dh / 2.0 - norm], -1)
        return out if tb.dim() == 3 else out[:, 0, :]

    return apply_op(_coder, prior_box, prior_box_var, target_box,
                    _op_name="box_coder")


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): soft suppression by the pairwise-IoU decay
    matrix, on the host in numpy as the reference's."""
    bb, sc = _host(bboxes), _host(scores)
    norm = 0.0 if normalized else 1.0
    outs, inds, nums = [], [], []
    for b in range(bb.shape[0]):
        dets = []
        for c in range(sc.shape[1]):
            if c == background_label:
                continue
            keep = np.where(sc[b, c] > score_threshold)[0]
            if keep.size == 0:
                continue
            s = sc[b, c][keep]
            order = np.argsort(-s)
            if nms_top_k > 0:
                order = order[:nms_top_k]
            s = s[order]
            boxes = bb[b][keep[order]]
            x1, y1, x2, y2 = boxes.T
            area = (x2 - x1 + norm) * (y2 - y1 + norm)
            ix1 = np.maximum(x1[:, None], x1[None, :])
            iy1 = np.maximum(y1[:, None], y1[None, :])
            ix2 = np.minimum(x2[:, None], x2[None, :])
            iy2 = np.minimum(y2[:, None], y2[None, :])
            iw = np.clip(ix2 - ix1 + norm, 0, None)
            ih = np.clip(iy2 - iy1 + norm, 0, None)
            iou = iw * ih / (area[:, None] + area[None, :] - iw * ih + 1e-10)
            iou = np.triu(iou, 1)
            iou_cmax = iou.max(0)
            if use_gaussian:
                decay = np.exp((iou_cmax[:, None] ** 2 - iou ** 2)
                               * gaussian_sigma).min(0)
            else:
                decay = ((1 - iou) / np.maximum(1 - iou_cmax[:, None],
                                                1e-10)).min(0)
            ds = s * decay
            for i, sv in enumerate(ds):
                if sv > post_threshold:
                    dets.append((c, sv, *boxes[i], keep[order][i]))
        dets.sort(key=lambda d: -d[1])
        if keep_top_k > 0:
            dets = dets[:keep_top_k]
        outs.append(np.asarray([d[:6] for d in dets], np.float32).reshape(
            -1, 6))
        inds.append(np.asarray([d[6] for d in dets], np.int32))
        nums.append(len(dets))
    out = _on_place(np.concatenate(outs, 0) if outs
                    else np.zeros((0, 6), np.float32))
    res = [out]
    if return_rois_num:
        res.append(_on_place(np.asarray(nums, np.int32)))
    if return_index:
        res.append(_on_place(np.concatenate(inds, 0)))
    return tuple(res) if len(res) > 1 else out


def read_file(filename, name=None):
    """Raw file bytes as a uint8 1-D Tensor."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).copy()
    return _on_place(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte Tensor to CHW uint8 on the host (PIL, imported
    here)."""
    import io

    from PIL import Image

    raw = bytes(_host(x).astype(np.uint8))
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _on_place(np.ascontiguousarray(arr))
