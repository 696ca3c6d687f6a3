"""train_it_per_s.host: training iterations completed in the window over
the window's seconds (host clock, ending in a synchronise), as
``train_it_per_s`` reads them, in a cell whose end-to-end metric is
``train_device_ms_per_iter``: there the host sets this rate and its speed
moves it by more than half the largest bound from run to run."""

from benchmark.spec import reader

read = reader("train_it_per_s")
