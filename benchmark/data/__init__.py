"""The benchmark's inputs, made from the seed: clips for requests and
training trees in the datasets' own layouts."""
