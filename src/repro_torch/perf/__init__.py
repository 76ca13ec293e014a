from repro_torch.perf.model import (DEFAULT_HW, HW, HW_PROFILES,  # noqa: F401
                                    layer_costs, prefill_time,
                                    simulate_iso_fractions, simulate_pipeline,
                                    speedup_table)
