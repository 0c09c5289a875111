"""The port's accuracy harnesses, run through ``omniserve_tpu_torch``:
teacher-forced perplexity (``ppl``), needle-in-a-haystack (``needle``),
sparse-vs-dense greedy agreement (``sparse_agreement``) and LongBench
(``longbench``). Tokenizers, ``transformers`` and ``rouge_score`` are
imported only where text is used; on a machine without them the
harnesses take token ids."""
