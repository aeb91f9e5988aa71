// The full-batch plan as K2 (stereo_factor_blocks.cu) and K3 (schur_uy.cu)
// read it: one struct, built and filled by ops/full_batch_plan.py::make_plan
// (its ctypes mirror _Plan must list the same fields in the same order;
// tests/test_torch_pcg.py checks both against this file).
#pragma once

// K3's landmark groups hold at most this many landmarks (GROUP_LANDMARKS in
// ops/full_batch_plan.py); a plan whose largest group (max_group) holds more
// is refused at launch.
constexpr int kGroupLandmarks = 32;

struct Plan {
  const int* pt_start;
  const int* pt_obs;
  const int* pt_pose;
  const int* pt_q;
  const int* lm_group;
  const int* ps_start;
  const int* ps_obs;
  const int* ps_point;
  const unsigned char* ps_valid;
  const unsigned char* ps_contig;
  const unsigned char* free_pose;
  const unsigned char* point_valid;
  const void* rec;
  void* y;
  void* hg;
  double fu, fv, cu, cv, fb;
  int K, J, N, G;
  int max_group;  // landmarks in the largest of K3's landmark groups
  int device;
  int multi_device;  // more than one device visible: launch on `device`
};
