"""General utilities: seeding, visualization, profiling."""
