"""On the card: `device.host_syncs` counts every host sync of a re-plan.

torch's sync debug mode warns at every synchronising CUDA operation; one
`solve_fleet` call on a tiny fleet must raise exactly as many of those
warnings as the counter grows. The file imports no JAX, so it runs on a
machine with the card (`python -m pytest tests/test_torch_host_syncs_card.py
-m cuda`); without one the test skips."""
import warnings

import pytest
import torch


@pytest.mark.cuda
def test_host_syncs_match_torchs_sync_debug_mode():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.fleet import sample_fleet, solve_fleet
    from repro_torch.obs import sync

    problems = sample_fleet(4, seed=3, n_range=(12, 20), apps_range=(3, 6), partitions=(1, 2),
                            device="cuda")
    kw = dict(m_max=3, t_phi=2, keep_state=True, device="cuda")
    solve_fleet(problems, **kw)  # builds and loads the kernels
    torch.cuda.synchronize()
    first = sync.host_syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve_fleet(problems, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    assert len(synced) == sync.host_syncs() - first > 0, sorted({f"{w.filename}:{w.lineno}" for w in synced})
