.PHONY: all native test smoke smoke-4 test-fast bench compat tables clean

all: native

native:
	python -m mp3rgain_tpu._native.build --force

test: native
	python -m pytest tests/ -q

# The card checks: the main path compiled for one GPU, compared with the
# CPU path (tests marked `gpu` skip in the CPU suite above).
smoke: native
	python chip_smoke.py

# The four-card data-parallel scan against a one-device mesh.
smoke-4: native
	python chip_smoke.py --four-cards

test-fast: native
	python -m pytest tests/ -q -x -k "not stress and not fuzz"

bench: native
	python bench.py

compat: native
	bash scripts/compatibility-test.sh

# Regenerate the format-constant tables from the system codec libraries.
tables:
	python tools/extract_huff_tables.py
	python tools/extract_synth_window.py
	python tools/extract_aac_tables.py

clean:
	rm -f mp3rgain_tpu/_native/libmp3rgain_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
