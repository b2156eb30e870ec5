# Developer entry points (the reference ships build.sh/run.sh; this is the
# Python/JAX equivalent).

.PHONY: test test-fast smoke bench bench-build native serve serve-noop clean

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -x

smoke:            ## the served path on one GPU, 1Mx768 (chip_smoke.py)
	python chip_smoke.py --seed 0

bench:            ## 1Mx768 QPS-at-recall benchmark on the GPU
	python bench.py

bench-build:      ## 10Mx768 -> 4096-centroid build benchmark (~25 min)
	python bench_build.py

native:           ## build the C++ host codec
	$(MAKE) -C vectorsearch_tpu/native

serve:            ## run the server (generates sample config on first run)
	python main.py config.json

serve-noop:       ## hermetic server with the deterministic fake embedder
	VSTPU_NOOP_AI=1 python main.py config.json

clean:
	rm -rf .cache .pytest_cache vectorsearch_tpu/native/libvscodec.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
