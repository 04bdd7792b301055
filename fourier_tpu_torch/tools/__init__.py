"""Command-line tools of the port: the comparative suite
(:mod:`.bench_suite`), the profiling loop (:mod:`.prof`) and the A/B of the
main path's call time between two trees (:mod:`.ab_main_path`)."""
