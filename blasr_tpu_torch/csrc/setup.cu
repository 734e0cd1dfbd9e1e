// The one set-up entry of the kernel library: every kernel's function
// attributes (the opt-ins to dynamic shared memory, K2's and K2-W's
// carveout), set on the current device before the first launch there.
//
// A launch sets no attribute itself, so a stream capture records launches
// only, and what a captured launch needs was set before the capture: an
// attribute set per call (K3 and K4 once set the exact size of each call)
// could be lowered by a later call and fail a replayed launch that needs
// more.  kernels/cuda_ops.py calls this once per device when it loads the
// library; a source built alone (chip_smoke.py --compare) is set up by its
// own blasr_<source>_setup.

extern "C" int blasr_banded_dp_setup();
extern "C" int blasr_banded_traceback_setup();
extern "C" int blasr_banded_dp_wide_setup();
extern "C" int blasr_banded_traceback_wide_setup();
extern "C" int blasr_chain_scan_setup();
extern "C" int blasr_sdp_window_setup();
extern "C" int blasr_anchor_search_setup();
extern "C" int blasr_band_offsets_setup();
extern "C" int blasr_chain_members_setup();

extern "C" int blasr_setup_kernels() {
  int (*const steps[])() = {
      blasr_banded_dp_setup,     blasr_banded_traceback_setup,
      blasr_chain_scan_setup,    blasr_sdp_window_setup,
      blasr_anchor_search_setup, blasr_band_offsets_setup,
      blasr_chain_members_setup, blasr_banded_dp_wide_setup,
      blasr_banded_traceback_wide_setup};
  for (auto step : steps) {
    const int rc = step();
    if (rc != 0) return rc;
  }
  return 0;
}
