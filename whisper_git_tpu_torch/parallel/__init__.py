"""Device-mesh parallelism for the render pipeline (the counterpart of
`whisper_git_tpu/parallel/`)."""
