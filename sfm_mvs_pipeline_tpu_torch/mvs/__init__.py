"""Dense multi-view stereo: depth maps, SGM, fusion, meshing, texturing.

Port of sfm_mvs_pipeline_tpu/mvs/ (the rect and sweep engines, --sgm with
kernels K2a and K2b, PatchMatch with kernel K3, fusion, mesh, texture,
refine).
"""
