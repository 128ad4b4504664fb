# Mirror of the reference Makefile targets (reference Makefile:1-31)

.PHONY: test bench submit_devnet_state submit_mainnet_state submit_account \
        deploy_example_bridge_contracts execute_example gen_contract_abis \
        submit_devnet_state_torch submit_mainnet_state_torch submit_account_torch \
        deploy_example_bridge_contracts_torch execute_example_torch \
        fixtures_pos_torch fixtures_pos_real_torch chip_smoke_torch

test:
	python -m pytest tests/ -x -q

bench:
	python bench.py

submit_devnet_state:
	python -m mina_bridge_tpu.cli submit-state --devnet

submit_mainnet_state:
	python -m mina_bridge_tpu.cli submit-state

submit_account:
	python -m mina_bridge_tpu.cli submit-account $(PUBLIC_KEY) $(STATE_HASH)

deploy_example_bridge_contracts:
	python -m mina_bridge_tpu.contract_deployer

# Requires foundry (not vendored): builds contracts/ and copies artifacts
gen_contract_abis:
	forge build --root contracts && \
	cp contracts/out/*/MinaBridgeRegistry.json contracts/abi/ && \
	cp contracts/out/*/MinaStateSettlement.json contracts/abi/ && \
	cp contracts/out/*/MinaAccountValidation.json contracts/abi/

execute_example:
	python example/app.py validate-solution $(ZKAPP_PUBLIC_KEY)

# The PyTorch/CUDA port (mina_bridge_tpu_torch/): the same entry points on
# an NVIDIA card, and its fixture banking on the card.

submit_devnet_state_torch:
	python -m mina_bridge_tpu_torch.cli submit-state --devnet

submit_mainnet_state_torch:
	python -m mina_bridge_tpu_torch.cli submit-state

submit_account_torch:
	python -m mina_bridge_tpu_torch.cli submit-account $(PUBLIC_KEY) $(STATE_HASH)

deploy_example_bridge_contracts_torch:
	python -m mina_bridge_tpu_torch.contract_deployer

execute_example_torch:
	python -m mina_bridge_tpu_torch.example.app validate-solution $(ZKAPP_PUBLIC_KEY)

fixtures_pos_torch:
	python3 scripts/torch_make_fixtures.py pos

fixtures_pos_real_torch:
	python3 scripts/torch_make_fixtures.py pos --block-log-n 17 --step-log-n 18 --batch 8

chip_smoke_torch:
	python3 chip_smoke.py
