"""Multi-process scaling on torch.distributed: sharded matching, BA and depth maps.

Port of sfm_mvs_pipeline_tpu/parallel/. The JAX package runs one SPMD
program over a device mesh of processes x local devices; the port runs
either the cards of one process as a mesh of threads (mesh.py) or one
process per rank (launched by torchrun), each on one device:

  * PAIRS  — descriptor matching shards the pair list (matching.py)
  * POINTS — bundle adjustment shards points and their observations; the
             reduced camera system is summed across the shards (ba.py)
  * VIEWS  — dense stereo shards the reference views (mvs.py)

Every rank repeats the replicated stages (features, RANSAC, PnP,
triangulation), so every sharded function checks at its entry that the
ranks hold the same inputs (distributed.check_agree) and returns
bit-identical results to all of them.
"""
