"""Scripts on the hermetic synthetic corpus, run with ``python -m``:

* ``make_ab_corpus`` — the A/B corpus (WAVs + fp64 golden features);
* ``synthetic_e2e`` — a corpus through ``cli.run_pipeline``, held-out
  accuracy;
* ``convergence_ab`` — the reference recipe on the corpus's features,
  accuracy over seeds;
* ``waveform_ab`` — feature-cached vs waveform-resident vs waveform +
  augmentation training on the same corpus.
"""
