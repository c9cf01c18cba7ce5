"""A cell's image sets: rendered by the frozen renderer from texture seeds.

The render's geometry is the same for every image set; a texture seed draws
its two textures. A render is a pure function of (views, size, f, texture
seed), so it is kept under h100bench/.cache/inputs/ in the checkout, keyed
by all four, and a later run reads it back.

How much work a set is depends on its images: a texture can make the SfM
restart its start and take half as long again. So a traffic mix whose runs
have to do the same work whatever the seed lists its textures
(`textures`): the unit of work is then one image set of each, in an order
drawn from --seed, and every run does whole units. A mix without the list
renders the textures of --seed itself, one image set a unit.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from h100bench.reference.synth import render_views


def unit_of(traffic: dict, seed: int) -> list[int]:
    """The texture seeds of one unit of work, in the order that `seed`
    draws: the traffic's `textures` permuted, or [seed]."""
    listed = traffic.get("textures")
    if not listed:
        return [seed % 2**64]
    order = np.random.default_rng(seed % 2**64).permutation(len(listed))
    return [int(listed[i]) for i in order]


def warm_texture(traffic: dict, seed: int) -> int:
    """The texture seed of the set-up's warm job: the first listed, so the
    set-up does the same work whatever the seed, or the seed's own."""
    listed = traffic.get("textures")
    return int(listed[0]) if listed else seed % 2**64


def image_set(home: str, scale: dict, texture_seed: int) -> tuple[str, np.ndarray, np.ndarray]:
    """(image dir, gt_R (V, 3, 3) world to camera, gt_C (V, 3)) of the
    render at `scale` ({views, width, height, f}) with the textures of
    `texture_seed`."""
    v, w, h, f = scale["views"], scale["width"], scale["height"], float(scale["f"])
    key = f"{v}x{w}x{h}_f{f:g}_seed{texture_seed}"
    base = os.path.join(home, ".cache", "inputs")
    done = os.path.join(base, key)
    gt = os.path.join(base, key + "_gt.npz")
    if not os.path.exists(gt):
        part = done + ".part"
        shutil.rmtree(part, ignore_errors=True)
        _, gt_R, gt_C = render_views(part, v, h, w, f, seed=texture_seed)
        shutil.rmtree(done, ignore_errors=True)
        os.replace(part, done)
        np.savez(gt + ".part.npz", R=gt_R, C=gt_C)
        os.replace(gt + ".part.npz", gt)
    truth = np.load(gt)
    return done, truth["R"], truth["C"]
