# Developer conveniences.
.PHONY: test demos bench native chip-smoke lint clean

test:
	python -m pytest tests/ -x -q

demos:
	python -m pytest demos/test_demos.py -x -q

bench:
	python bench.py

native:
	./native/build.sh

chip-smoke:
	python chip_smoke.py

clean:
	rm -rf demos/results_* demos/demo_perf_output .pytest_cache .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
