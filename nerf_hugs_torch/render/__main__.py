from nerf_hugs_torch.render.driver import main

if __name__ == "__main__":
    main()
