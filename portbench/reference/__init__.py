"""Plain references of the benchmark's configurations: float64 replays in
plain torch of the steps the program runs, built from the generator's raw
keys and labels. Nothing here imports the program."""
